#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (myrtle_vision_tpu_torch).

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each ending in one line of output:
  1. device   the card (torch and nvidia-smi), torch / CUDA / nvcc versions
  2. build    csrc/*.cu compiled for sm_90a into the git-ignored build dir
  3. kernels  each CUDA kernel, forward and backward, and each block-half
              chain, forward and backward, against its plain PyTorch
              version on the card, bf16, ViT-S/16 shapes (B=64, N=197,
              C=384, 6 heads, MLP 1536) and a ragged case (B=3, N=50);
              the converted-INT8 kernels and block-half chains at the same
              shapes, fp32 activations and int8 weights, with the sites of
              a real calibration of the block
  4. main     the ViT-S/16 eval CLI on a synthetic RESISC-layout dataset
              with seeded random weights: launch counts, logits of the
              kernel path against the plain path
  5. train    the ViT-S/16 train CLI (classification/train_configs/
              vit_small.json: local batch 32, 2 micro-batches per step) for
              one epoch of the same dataset at 224 px: launch counts of
              every block's forward and backward, finite losses, the first
              step's loss and gradients against the plain path, and the
              written checkpoint through the eval CLI
  6. quantize the PTQ CLI (test_quantize) on vit_small.json in PyTorchINT8
              with phase 4's weights: 2 calibration batches, convert, the
              converted checkpoint, the test split through the INT8
              kernels; launch counts, the converted logits against the
              plain path, the checkpoint's size
  7. timing   CUDA-event times at batch 256: each kernel, forward and
              backward, and each chain against its plain version and,
              where one exists, a PyTorch call of the same function (a
              yardstick the port never calls); the whole-model forward (bf16
              and converted INT8) and one train step in images per second
Then the JSON line of kernels, the card's name and power limit, and as
the last line {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero before that line; without a CUDA device it exits at once.
"""
import contextlib
import glob
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "runs", "chip_smoke")

# ViT-S/16 at 224 px
C, HEADS, HID, N = 384, 6, 1536, 197
SCALE = (C // HEADS) ** -0.5
# Kernel against plain version, both bf16 with the same rounding points:
# only the order of fp32 sums differs, which can move a value across a
# bf16 rounding boundary (one step, at most 2^-7 of it).  Bar, per
# element: |kernel - plain| <= RTOL * |plain| + ATOL, RTOL two bf16
# steps.  A single kernel rounds once, so ATOL only absorbs fp32 noise;
# a block-half chain (and the attention core's backward, which rounds
# du, e and ds inside) can carry a flipped intermediate (xn, qkv, context,
# GELU output, ds) through the next product into outputs near zero,
# which the chain's ATOL covers.  A weight, bias or LayerNorm gradient is
# a sum over the B*N rows in which a flipped intermediate moves one term,
# so its ATOL is 2^-8 of the tensor's largest magnitude.  Biases and
# upstream gradients are drawn at std 1, so a kernel that drops its bias
# misses the bar by about 2^7 (std 1 against 2^-7).
RTOL = 2.0 ** -6
KERNEL_ATOL = 2.0 ** -7
CHAIN_ATOL = 2.0 ** -6
SUM_ATOL = 2.0 ** -8
# The attention core's per-image dbqkv column sums add at most 197 of its
# own fp32 values, where kernel and plain version part only at a flipped
# du, e or ds; bar 2^-12 of the largest sum, no relative term.  Measured
# at most 6.1e-5 of it (B=64) and 1.0e-5 (B=3); summing the bf16-rounded
# values instead moves them by 7.9e-4 and 1.1e-3 (H100 80GB HBM3, 700 W).
PSUM_ATOL = 2.0 ** -12
# Whole model (12 blocks): per-block differences accumulate in the
# residual stream; bar on logits 2^-4 of their largest magnitude, and
# argmax agreement on at least 99% of the images.
LOGIT_BAR = 2.0 ** -4
ARGMAX_BAR = 0.99
# First train step, kernel path against plain path (same weights and
# batch): the mean loss within 2^-6 of its value, and each parameter's
# gradient within 2^-4 of its norm (relative L2 error), since flipped
# bf16 intermediates of 12 blocks' forward and backward add up in it.
LOSS_BAR = 2.0 ** -6
GRAD_BAR = 2.0 ** -4
# Converted INT8, kernel against plain version: the integer products are
# exact in both and every other step runs the same fp32 operations in the
# same order, but for the order of fp32 sums (LayerNorm statistics,
# softmax rowsum, the 3-pass products) and PyTorch's own rewrites of the
# plain GELU (a divide by a constant becomes a multiply); such a
# difference moves an output only where it flips a rint.  Bar, per
# output: at least 99.9% of the elements identical and none more than 2
# steps of its grid apart (the site's scale, or 1 for int8).  In a
# block-half chain one flipped intermediate moves the whole row of the
# product after it and, through a key or value, the attention of every
# query of its image, so a chain may differ in up to 1% of its elements
# (measured 0.48% at the ragged B=3, N=50, H100 80GB HBM3, 700 W); and a
# one-step flip on a projection's output grid (site 3) reaches the
# residual sum's grid (site 4) as up to ceil(s3 / s4) + 1 steps (measured
# 2 in block 0 of the converted model), so a chain's bar is 4 steps.  The
# converted model is held stage by stage, each
# stage of the kernel path fed the plain path's input: the embedding to
# the kernel bar, each block and the head to the chain bar.  End to end,
# flips compound over 12 quantized blocks through the cls token, which
# attends to every token (measured: logits 10 steps of the head's grid
# apart, 0.1006 against a largest logit of 1.397, 27% of them identical,
# argmax on 117 of 120 images, random weights on synthetic images giving
# chance-level top-1 margins; H100 80GB HBM3, 700 W): bar 2^-3 of the
# largest logit, argmax agreement on at least 95% of the images.
INT8_SAME = 0.999
INT8_CHAIN_SAME = 0.99
INT8_STEPS = 2
INT8_CHAIN_STEPS = 4
INT8_LOGIT_BAR = 2.0 ** -3
INT8_ARGMAX_BAR = 0.95
# Peak rates of one H100 SXM (NVIDIA's data sheet, dense), for the least
# time the card could take: bytes at 3.35 TB/s, operations at the peak of
# their type (fp32 outside the tensor cores for the elementwise kernels).
HBM_BYTES_PER_S = 3.35e12
PEAK = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}

# the TPU kernels these CUDA kernels replace (file:line of the Pallas body)
TPU_ATTN = "myrtle_vision_tpu/ops/fused_attention_block.py:196"
TPU_MLP = "myrtle_vision_tpu/ops/fused_mlp.py:159"
TPU_ATTN_BWD = "myrtle_vision_tpu/ops/fused_attention_block.py:370"
TPU_MLP_BWD = "myrtle_vision_tpu/ops/fused_mlp.py:215"
TPU_INT8_ATTN = "myrtle_vision_tpu/ops/fused_int8_block.py:161"
TPU_INT8_MLP = "myrtle_vision_tpu/ops/fused_int8_block.py:207"
CSRC = "myrtle_vision_tpu_torch/csrc/"
ALL_FOUR = f"{TPU_ATTN}; {TPU_MLP}; {TPU_ATTN_BWD}; {TPU_MLP_BWD}"
INT8_BOTH = f"{TPU_INT8_ATTN}; {TPU_INT8_MLP}"
# per kernel: its source and the TPU kernels it replaces; the first six
# run on the FP32 path (phases 4 and 5), the last three on the converted
# INT8 path (phase 6)
KERNELS = {
    "layernorm_rows": (CSRC + "layernorm_rows.cu", ALL_FOUR),
    "gemm_bf16_epilogue": (CSRC + "gemm_bf16_epilogue.cu", ALL_FOUR),
    "attention_core": (CSRC + "attention_core.cu", TPU_ATTN),
    "attention_core_bwd": (CSRC + "attention_core_bwd.cu", TPU_ATTN_BWD),
    "layernorm_rows_bwd": (CSRC + "layernorm_rows_bwd.cu",
                           f"{TPU_ATTN_BWD}; {TPU_MLP_BWD}"),
    "colsum_rows": (CSRC + "layernorm_rows_bwd.cu",
                    f"{TPU_ATTN_BWD}; {TPU_MLP_BWD}"),
    "layernorm_quant_rows": (CSRC + "layernorm_quant_rows.cu", INT8_BOTH),
    "gemm_s8_epilogue": (CSRC + "gemm_s8_epilogue.cu", INT8_BOTH),
    "attention_core_f32": (CSRC + "attention_core_f32.cu", TPU_INT8_ATTN),
}
INT8_KERNELS = ("layernorm_quant_rows", "gemm_s8_epilogue",
                "attention_core_f32")
# each TPU kernel: the chain that replaces it and the kernel cases that
# chain runs once per call, for its bound and yardstick sums
_G = "gemm_bf16_epilogue"
TPU_CHAINS = {
    "K1": ("fused_attention_block", [
        "layernorm_rows", f"{_G}[qkv,bias]", "attention_core[stats]",
        f"{_G}[proj,bias+residual]"]),
    "K2": ("fused_attention_block[bwd,saved qkv]", [
        "layernorm_rows", f"{_G}[d_o=do.Wp^T,f32]", "attention_core_bwd", "colsum_rows[dbqkv]",
        f"{_G}[dWp=do^T.ctx,A^T]", "colsum_rows[dbp,db2]",
        f"{_G}[dWqkv=dqkv^T.xn,A^T]", f"{_G}[dxn=dqkv.Wqkv^T,f32]",
        "layernorm_rows_bwd"]),
    "K3": ("fused_mlp_block", [
        "layernorm_rows", f"{_G}[fc1,bias+gelu]", f"{_G}[fc2,bias+residual]"]),
    "K4": ("fused_mlp_block[bwd]", [
        "layernorm_rows", f"{_G}[fc1 remat,bias+gelu+gelu']",
        f"{_G}[dW2=do^T.g,A^T]", "colsum_rows[dbp,db2]",
        f"{_G}[dh=do.W2^T*gelu',colsum]", f"{_G}[dW1=dh^T.xn,A^T]",
        f"{_G}[dxn=dh.W1^T,f32]", "layernorm_rows_bwd"]),
    "K9": ("int8_attention_block", [
        "layernorm_quant_rows", "gemm_s8_epilogue[qkv,requant]",
        "attention_core_f32", "gemm_s8_epilogue[out,requant+residual+requant]"]),
    "K10": ("int8_mlp_block", [
        "layernorm_quant_rows", "gemm_s8_epilogue[fc1,requant+gelu+quant]",
        "gemm_s8_epilogue[fc2,requant+residual+requant]"]),
}
FP32_KERNELS = tuple(k for k in KERNELS if k not in INT8_KERNELS)


def check(ok, message):
    """Fail the run (a raise, so that it survives python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {message}")


def require_cuda():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs on a CUDA device only")


def power_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def _ops():
    from myrtle_vision_tpu_torch.ops.fused_attention_block import (
        fused_attention_block,
    )
    from myrtle_vision_tpu_torch.ops.fused_int8_block import (
        int8_attention_block,
        int8_mlp_block,
    )
    from myrtle_vision_tpu_torch.ops.fused_mlp import fused_mlp_block

    return (fused_attention_block, fused_mlp_block), (int8_attention_block,
                                                      int8_mlp_block)


def reset_counts():
    from myrtle_vision_tpu_torch.ops import _kernels as K

    K.reset_launches()
    fp32_ops, int8_ops = _ops()
    for op in fp32_ops:
        op.launches = op.bwd_launches = 0
    for op in int8_ops:
        op.launches = 0


def read_counts():
    """(kernel launches, {op: (forward, backward) launches}), the INT8
    ops (forward only) counted as (forward, 0)."""
    from myrtle_vision_tpu_torch.ops import _kernels as K

    torch.cuda.synchronize()
    fp32_ops, int8_ops = _ops()
    ops = {op.__name__: (op.launches, op.bwd_launches) for op in fp32_ops}
    ops.update({op.__name__: (op.launches, 0) for op in int8_ops})
    return dict(K.LAUNCHES), ops


def phase_device():
    from myrtle_vision_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: "
          f"{power_line()} | count {torch.cuda.device_count()}")
    print(f"versions: python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} nvcc "
          f"{nvcc.splitlines()[-1]}")


def phase_build():
    from myrtle_vision_tpu_torch.ops import _build

    fresh = not _build.library_path().exists()
    t0 = time.perf_counter()
    path = _build.build(verbose=fresh)
    _build.lib()
    took = time.perf_counter() - t0
    srcs = ", ".join(os.path.relpath(p, ROOT) for p in _build.sources())
    print(f"build: {'built' if fresh else 'reused'} "
          f"{os.path.relpath(path, ROOT)} from {srcs} in {took:.2f} s "
          f"(one nvcc per source, in parallel; {_build.NVCC_FLAGS[1]})")


def seeded(rng, shape, std, device, dtype=torch.float32):
    return torch.from_numpy(
        (rng.randn(*shape) * std).astype(np.float32)
    ).to(device=device, dtype=dtype)


def block_inputs(b, n, seed, device):
    """bf16 activations and upstream gradient, fp32 parameters of one
    block, from a numpy seed.  Each weight is the (in, out) view of a
    torch (out, in) tensor, as the ViT block passes it, so the kernels
    read every weight in the main path's layout.  Biases and the upstream
    gradient are std 1, as large as what they are added to, so that each
    one shows in the output."""
    rng = np.random.RandomState(seed)
    x = seeded(rng, (b, n, C), 1.0, device, torch.bfloat16)
    attn = [seeded(rng, (C,), 0.1, device) + 1, seeded(rng, (C,), 0.1, device),
            seeded(rng, (3 * C, C), C ** -0.5, device).t(),
            seeded(rng, (3 * C,), 1.0, device),
            seeded(rng, (C, C), C ** -0.5, device).t(),
            seeded(rng, (C,), 1.0, device)]
    mlp = [seeded(rng, (C,), 0.1, device) + 1, seeded(rng, (C,), 0.1, device),
           seeded(rng, (HID, C), C ** -0.5, device).t(),
           seeded(rng, (HID,), 1.0, device),
           seeded(rng, (C, HID), HID ** -0.5, device).t(),
           seeded(rng, (C,), 1.0, device)]
    do = seeded(rng, (b, n, C), 1.0, device, torch.bfloat16)
    return x, attn, mlp, do


def bar(kind, ref):
    """(rtol, atol) of a bar kind for reference output ``ref``."""
    if kind == "kernel":
        return RTOL, KERNEL_ATOL
    if kind == "chain":
        return RTOL, CHAIN_ATOL
    largest = ref.float().abs().max().item()
    if kind == "psum":
        return 0.0, PSUM_ATOL * largest
    return RTOL, SUM_ATOL * max(1.0, largest)


def compare(label, got, ref, rtol, atol):
    """Max abs difference, and the largest share of its element's bar
    rtol * |ref| + atol that any element takes (at most 1 to pass)."""
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{label}: {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}")
    g, r = got.float(), ref.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite output")
    diff = (g - r).abs()
    max_abs = diff.max().item()
    of_bar = (diff / (rtol * r.abs() + atol)).max().item()
    check(of_bar <= 1.0, f"{label}: max abs {max_abs}, {of_bar:.3g} x its "
          f"element's bar {rtol:g} * |ref| + {atol:g}")
    return max_abs, of_bar


def as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def cost(moved, ops, peak, library=None):
    """What bounds a case: bytes it must move (each input read once, each
    output written once), operations of type ``peak``, and a thunk of one
    PyTorch call of the same function (a yardstick) or None."""
    return {"bytes": moved, "ops": ops, "peak": peak, "library": library}


def bound(c):
    """(least ms on the card, what bounds it) of a cost."""
    t_bytes = c["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = c["ops"] / PEAK[c["peak"]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def heads_of(qkv3):
    """q, k, v (B, H, N, D) of (B, N, 3C) rows, contiguous."""
    b, n, c3 = qkv3.shape
    t = qkv3.view(b, n, 3, HEADS, c3 // 3 // HEADS).permute(2, 0, 3, 1, 4)
    return [u.contiguous() for u in t]


def kernel_cases(x, attn, mlp, do):
    """(name, kernel thunk, plain thunk, bar kind of each output, launches
    per block in a train step, cost) for each CUDA kernel at the shapes
    and operand layouts the main path gives it, inputs prepared with the
    plain versions the way the ops prepare them: the forward GEMMs read
    the weights column-major (the (in, out) view of a torch (out, in)
    weight), the backward data-gradient GEMMs row-major.  The other
    layout of each is a check case with count 0 (", other layout").  A
    weight-gradient GEMM's time includes the sum of its split-K partial
    products.  The yardsticks: ``F.layer_norm`` and its backward,
    ``torch.matmul`` of the same bf16 operands, the flash attention of
    ``F.scaled_dot_product_attention`` forward and backward, and
    ``torch.sum``."""
    import torch.nn.functional as F

    from myrtle_vision_tpu_torch.ops import _kernels as K

    bf = torch.bfloat16
    b, n, _ = x.shape
    rows = b * n
    x2, do2 = x.view(rows, C), do.view(rows, C)
    s, bi = attn[0].to(bf), attn[1].to(bf)
    xn = K.layernorm_rows_plain(x2, s, bi)
    wqkv, bqkv = attn[2].to(bf), attn[3]
    qkv = K.gemm_bf16_epilogue_plain(xn, wqkv, bqkv, "bias")
    wp, bp = attn[4].to(bf), attn[5].to(bf).float()
    w1, b1 = mlp[2].to(bf), mlp[3].to(bf).float()
    w2, b2 = mlp[4].to(bf), mlp[5].to(bf).float()
    check(not wqkv.is_contiguous() and wqkv.t().is_contiguous()
          and wp.t().is_contiguous() and w1.t().is_contiguous()
          and w2.t().is_contiguous(), "weights not in the main path's layout")
    g = K.gemm_bf16_epilogue_plain(xn, w1, b1, "bias_gelu")
    qkv3 = qkv.view(b, n, 3 * C)
    ctx, m, rs = K.attention_core_plain(qkv3, HEADS, SCALE, stats=True)
    ctx = ctx.view(rows, C)
    # the same weights laid out the other way
    wqkv_o, wp_o = wqkv.contiguous(), wp.contiguous()
    # backward intermediates
    d_o = K.gemm_bf16_epilogue_plain(do2, wp.t(), None, "f32")
    dqkv, dbq_image = K.attention_core_bwd_plain(
        qkv3, d_o.view(b, n, C), m, rs, HEADS, SCALE)
    dqkv = dqkv.view(rows, 3 * C)
    dxn = K.gemm_bf16_epilogue_plain(dqkv, wqkv.t(), None, "f32")
    g_r, gp = K.gemm_bf16_epilogue_plain(xn, w1, b1, "bias_gelu_grad")
    dh, _ = K.gemm_bf16_epilogue_plain(do2, w2.t(), None, "mul_aux", aux=gp)
    gemm = (K.gemm_bf16_epilogue_cuda, K.gemm_bf16_epilogue_plain)

    def mm(name, args, kinds, count, **kw):
        a, w, bias, epilogue = args
        m, k, nn = a.shape[0], a.shape[1], w.shape[1]
        out = {"f32": 4, "bias_gelu_grad": 6}.get(epilogue, 2) * m * nn
        extra = nbytes(bias, kw.get("residual"), kw.get("aux"))
        c = cost(nbytes(a, w) + out + extra, 2 * m * nn * k, "bf16",
                 lambda: torch.matmul(a, w))
        return (f"gemm_bf16_epilogue[{name}]",
                lambda: gemm[0](*args, **kw), lambda: gemm[1](*args, **kw),
                kinds, count, c)

    q, k, v = heads_of(qkv3)
    core_ops = 4 * b * HEADS * n * n * (C // HEADS)
    d_oh = heads_of(torch.cat([d_o.view(b, n, C)] * 3, -1).to(bf))[0]
    flash = []  # the forward's outputs, made at the first (warm-up) call

    def flash_bwd():
        if not flash:
            flash.extend(torch.ops.aten._scaled_dot_product_flash_attention(
                q, k, v, 0.0, False, False, scale=SCALE))
        out, lse, cq, ck, mq, mk, ps, po = flash[:8]
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            d_oh, q, k, v, out, lse, cq, ck, mq, mk, 0.0, False, ps, po,
            scale=SCALE)

    ln_mean, ln_rstd = torch.ops.aten.native_layer_norm(x2, [C], s, bi,
                                                        K.EPS)[1:]
    dxn_bf = dxn.to(bf)
    stats = 2 * b * HEADS * n * 4
    return [
        ("layernorm_rows", lambda: K.layernorm_rows_cuda(x2, s, bi),
         lambda: K.layernorm_rows_plain(x2, s, bi), ("kernel",), 4,
         cost(2 * nbytes(x2) + nbytes(s, bi), 8 * x2.numel(), "fp32",
              lambda: F.layer_norm(x2, (C,), s, bi, K.EPS))),
        mm("qkv,bias", (xn, wqkv, bqkv, "bias"), ("kernel",), 1),
        mm("qkv,bias, other layout", (xn, wqkv_o, bqkv, "bias"),
           ("kernel",), 0),
        mm("proj,bias+residual", (ctx, wp, bp, "bias_residual"), ("kernel",),
           1, residual=x2),
        mm("fc1,bias+gelu", (xn, w1, b1, "bias_gelu"), ("kernel",), 1),
        mm("fc2,bias+residual", (g, w2, b2, "bias_residual"), ("kernel",), 1,
           residual=x2),
        ("attention_core", lambda: K.attention_core_cuda(qkv3, HEADS, SCALE),
         lambda: K.attention_core_plain(qkv3, HEADS, SCALE), ("kernel",), 0,
         cost(nbytes(qkv3) * 4 // 3, core_ops, "bf16",
              lambda: F.scaled_dot_product_attention(q, k, v, scale=SCALE))),
        ("attention_core[stats]",
         lambda: K.attention_core_cuda(qkv3, HEADS, SCALE, stats=True),
         lambda: K.attention_core_plain(qkv3, HEADS, SCALE, stats=True),
         ("kernel", "kernel", "kernel"), 1,
         cost(nbytes(qkv3) * 4 // 3 + stats, core_ops, "bf16",
              lambda: F.scaled_dot_product_attention(q, k, v, scale=SCALE))),
        # backward
        mm("d_o=do.Wp^T,f32", (do2, wp.t(), None, "f32"), ("kernel",), 1),
        mm("d_o=do.Wp^T,f32, other layout", (do2, wp_o.t(), None, "f32"),
           ("kernel",), 0),
        ("attention_core_bwd",
         lambda: K.attention_core_bwd_cuda(qkv3, d_o.view(b, n, C), m, rs,
                                           HEADS, SCALE),
         lambda: K.attention_core_bwd_plain(qkv3, d_o.view(b, n, C), m, rs,
                                            HEADS, SCALE),
         ("chain", "psum"), 1,
         cost(2 * nbytes(qkv3) + nbytes(d_o, m, rs, dbq_image),
              core_ops * 5 // 2, "bf16", flash_bwd)),
        ("colsum_rows[dbqkv]", lambda: K.colsum_rows_cuda(dbq_image),
         lambda: K.colsum_rows_plain(dbq_image), ("sum",), 1,
         cost(nbytes(dbq_image) + 4 * dbq_image.shape[1], dbq_image.numel(),
              "fp32", lambda: torch.sum(dbq_image, 0))),
        mm("dWp=do^T.ctx,A^T", (do2.t(), ctx, None, "f32"), ("sum",), 1),
        ("colsum_rows[dbp,db2]", lambda: K.colsum_rows_cuda(do2),
         lambda: K.colsum_rows_plain(do2), ("sum",), 2,
         cost(nbytes(do2) + 4 * C, do2.numel(), "fp32",
              lambda: torch.sum(do2, 0, dtype=torch.float32))),
        mm("dWqkv=dqkv^T.xn,A^T", (dqkv.t(), xn, None, "f32"), ("sum",), 1),
        mm("dxn=dqkv.Wqkv^T,f32", (dqkv, wqkv.t(), None, "f32"), ("kernel",),
           1),
        mm("dxn=dqkv.Wqkv^T,f32, other layout",
           (dqkv, wqkv_o.t(), None, "f32"), ("kernel",), 0),
        ("layernorm_rows_bwd",
         lambda: K.layernorm_rows_bwd_cuda(x2, s, dxn, do2),
         lambda: K.layernorm_rows_bwd_plain(x2, s, dxn, do2),
         ("kernel", "sum", "sum"), 2,
         cost(nbytes(x2, s, dxn, do2, x2) + 8 * C, 12 * x2.numel(), "fp32",
              lambda: torch.ops.aten.native_layer_norm_backward(
                  dxn_bf, x2, [C], ln_mean, ln_rstd, s, bi,
                  [True, True, True]))),
        mm("fc1 remat,bias+gelu+gelu'", (xn, w1, b1, "bias_gelu_grad"),
           ("kernel", "kernel"), 1),
        mm("dW2=do^T.g,A^T", (do2.t(), g_r, None, "f32"), ("sum",), 1),
        mm("dh=do.W2^T*gelu',colsum", (do2, w2.t(), None, "mul_aux"),
           ("kernel", "sum"), 1, aux=gp),
        mm("dW1=dh^T.xn,A^T", (dh.t(), xn, None, "f32"), ("sum",), 1),
        mm("dxn=dh.W1^T,f32", (dh, w1.t(), None, "f32"), ("kernel",), 1),
    ]


def int8_block_inputs(b, n, seed, device):
    """fp32 activations and one converted ViT-S/16 block's operands:
    seeded fp32 weights (Linear U(+-1/sqrt(fan_in)) and biases std 1,
    LayerNorm 1 + noise), calibrated by the block's own calibrating
    forward on these activations, converted, and loaded as the converted
    model loads them; each int8 weight the (in, out) view of the torch
    (out, in) tensor, as the converted block passes it."""
    from myrtle_vision_tpu_torch.models.vit import Block
    from myrtle_vision_tpu_torch.ops.fused_int8_block import weight_colsum
    from myrtle_vision_tpu_torch.quantize import (
        QFormat,
        convert_params,
        is_observer,
    )

    rng = np.random.RandomState(seed)
    x = seeded(rng, (b, n, C), 1.0, device)
    fp, conv = (Block(C, HEADS, C // HEADS, HID, 0.0, 12, device,
                      QFormat.PyTorchINT8, converted)
                for converted in (False, True))
    sd = {}
    for name, t in fp.state_dict().items():
        shape = tuple(t.shape)
        if is_observer(name):
            sd[name] = t
        elif name.endswith("norm.weight"):
            sd[name] = 1 + 0.1 * rng.randn(*shape)
        elif name.endswith("norm.bias"):
            sd[name] = 0.1 * rng.randn(*shape)
        elif t.dim() == 2:
            bound_ = shape[1] ** -0.5
            sd[name] = rng.uniform(-bound_, bound_, shape)
        else:
            sd[name] = rng.randn(*shape)
    fp.load_state_dict({k: torch.as_tensor(np.asarray(v, np.float32))
                        if not torch.is_tensor(v) else v
                        for k, v in sd.items()})
    with torch.no_grad():
        fp.forward_calibrating(x)
    conv.load_state_dict(convert_params(fp.state_dict(), "PyTorchINT8"))
    for lin in conv._linears():
        lin.weight_colsum.copy_(weight_colsum(lin.weight.t()))
    sites = conv.site_table()
    a, f = conv._modules["0"].fn, conv._modules["1"].fn
    qkv, out, fc1, fc2 = conv._linears()
    attn = [a.norm.weight, a.norm.bias, qkv.weight.t(), qkv.weight_scale,
            qkv.bias, out.weight.t(), out.weight_scale, out.bias, sites[0]]
    mlp = [f.norm.weight, f.norm.bias, fc1.weight.t(), fc1.weight_scale,
           fc1.bias, fc2.weight.t(), fc2.weight_scale, fc2.bias, sites[1]]
    colsums = ((qkv.weight_colsum, out.weight_colsum),
               (fc1.weight_colsum, fc2.weight_colsum))
    return x, attn, mlp, colsums


def int8_kernel_cases(x, attn, mlp, colsums):
    """(name, kernel thunk, plain thunk, the step of the output's grid,
    launches per converted block in a forward, cost) for each converted
    INT8 kernel at the main path's shapes and layouts, inputs prepared
    with the plain versions as the ops chain them.  Yardsticks:
    ``torch._int_mm`` of the same int8 operands, and
    ``F.scaled_dot_product_attention`` in fp32 (no single PyTorch call
    does LayerNorm and quantization at once)."""
    import torch.nn.functional as F

    from myrtle_vision_tpu_torch.ops import _kernels as K

    b, n, _ = x.shape
    x2 = x.view(-1, C)
    ln_a, ln_b, wqkv, sqkv, bqkv, wout, sout, bout, sa = attn
    ln_m, ln_mb, w1, s1, b1, w2, s2, b2, sm = mlp
    (cs_qkv, cs_out), (cs1, cs2) = colsums
    q8 = K.layernorm_quant_rows_plain(x2, ln_a, ln_b, sa[0])
    qkv = K.gemm_s8_epilogue_plain(q8, wqkv, cs_qkv, sqkv, sa[0], bqkv,
                                   "requant", sa[1])
    qkv3 = qkv.view(b, n, 3 * C)
    ctx8 = K.attention_core_f32_plain(qkv3, HEADS, SCALE, sa[2]).view(-1, C)
    h8 = K.layernorm_quant_rows_plain(x2, ln_m, ln_mb, sm[0])
    g8 = K.gemm_s8_epilogue_plain(h8, w1, cs1, s1, sm[0], b1,
                                  "requant_gelu_quant", sm[1], sm[2])
    q, k, v = heads_of(qkv3)

    def mm(name, a, w, cs, scale, a_site, bias, epilogue, site, site2,
           step, residual=None):
        args = (a, w, cs, scale, a_site, bias, epilogue, site, site2)
        m, kk, nn = a.shape[0], a.shape[1], w.shape[1]
        out = m * nn * (1 if epilogue == "requant_gelu_quant" else 4)
        c = cost(nbytes(a, w, cs, bias, residual) + out, 2 * m * nn * kk,
                 "int8", lambda: torch._int_mm(a, w))
        return (f"gemm_s8_epilogue[{name}]",
                lambda: K.gemm_s8_epilogue_cuda(*args, residual=residual),
                lambda: K.gemm_s8_epilogue_plain(*args, residual=residual),
                step, 1, c)

    return [
        ("layernorm_quant_rows",
         lambda: K.layernorm_quant_rows_cuda(x2, ln_a, ln_b, sa[0]),
         lambda: K.layernorm_quant_rows_plain(x2, ln_a, ln_b, sa[0]), 1.0, 2,
         cost(nbytes(x2) * 5 // 4 + nbytes(ln_a, ln_b), 10 * x2.numel(),
              "fp32")),
        mm("qkv,requant", q8, wqkv, cs_qkv, sqkv, sa[0], bqkv, "requant",
           sa[1], None, float(sa[1][0])),
        ("attention_core_f32",
         lambda: K.attention_core_f32_cuda(qkv3, HEADS, SCALE, sa[2]),
         lambda: K.attention_core_f32_plain(qkv3, HEADS, SCALE, sa[2]), 1.0,
         1, cost(nbytes(qkv3) + qkv3.numel() // 3,
                 3 * 4 * b * HEADS * n * n * (C // HEADS), "bf16",
                 lambda: F.scaled_dot_product_attention(q, k, v,
                                                        scale=SCALE))),
        mm("out,requant+residual+requant", ctx8, wout, cs_out, sout, sa[2],
           bout, "requant_residual_requant", sa[3], sa[4], float(sa[4][0]),
           residual=x2),
        mm("fc1,requant+gelu+quant", h8, w1, cs1, s1, sm[0], b1,
           "requant_gelu_quant", sm[1], sm[2], 1.0),
        mm("fc2,requant+residual+requant", g8, w2, cs2, s2, sm[2], b2,
           "requant_residual_requant", sm[3], sm[4], float(sm[4][0]),
           residual=x2),
    ]


def int8_op_cases(x, attn, mlp, colsums):
    """(name, kernel thunk, plain thunk, step of the output grid) of both
    converted-INT8 block-half chains."""
    from myrtle_vision_tpu_torch.ops import fused_int8_block as fi

    return [
        ("int8_attention_block",
         lambda: fi.int8_attention_block(x, *attn, HEADS, SCALE,
                                         colsums=colsums[0]),
         lambda: fi.int8_attention_block_plain(x, *attn, HEADS, SCALE,
                                               colsums=colsums[0]),
         float(attn[-1][4][0])),
        ("int8_mlp_block",
         lambda: fi.int8_mlp_block(x, *mlp, colsums=colsums[1]),
         lambda: fi.int8_mlp_block_plain(x, *mlp, colsums=colsums[1]),
         float(mlp[-1][4][0])),
    ]


def compare_grid(label, got, ref, step, same=INT8_SAME, steps=INT8_STEPS):
    """Max abs difference, and the largest share of the INT8 bar (share of
    differing elements against 1 - ``same``, steps apart against
    ``steps``) that the output takes (at most 1 to pass)."""
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{label}: {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}")
    g, r = got.float(), ref.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite output")
    diff = (g - r).abs()
    max_abs = diff.max().item()
    differ = (diff > 0).float().mean().item()
    of_bar = max(differ / (1 - same),
                 max_abs / (steps * step * (1 + 1e-5)))
    check(of_bar <= 1.0, f"{label}: {differ:.3g} of the elements differ, max "
          f"abs {max_abs} ({max_abs / step:.3g} steps of {step:g})")
    return max_abs, of_bar


def op_cases(x, attn, mlp, do):
    """(name, kernel thunk, plain thunk, bar kinds) of each block-half
    chain, forward and backward (with the qkv rows saved and recomputed).
    Each path's backward starts from its own forward's residuals, as on
    the main path: rows recomputed by one GEMM have to meet the rowmax
    and rowsum that the same GEMM's rows gave in the forward."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops import fused_attention_block as fa
    from myrtle_vision_tpu_torch.ops import fused_mlp as fm

    res_kernel = fa._forward(K.CUDA, x, *attn, HEADS, SCALE, record=True)[1]
    res_plain = fa._forward(K.PLAIN, x, *attn, HEADS, SCALE, record=True)[1]
    attn_bwd = attn[:-1]  # the backward takes no bp
    grads = ("chain",) + ("sum",) * 6

    def attn_back(kern, saved):
        ctx, m, rs, qkv = res_kernel if kern is K.CUDA else res_plain
        return fa._backward(kern, do, x, *attn_bwd, ctx, m, rs,
                            qkv if saved else None, HEADS, SCALE)

    return [
        ("fused_attention_block",
         lambda: fa.fused_attention_block(x, *attn, HEADS, SCALE),
         lambda: fa.fused_attention_block_plain(x, *attn, HEADS, SCALE),
         ("chain",)),
        ("fused_mlp_block",
         lambda: fm.fused_mlp_block(x, *mlp),
         lambda: fm.fused_mlp_block_plain(x, *mlp), ("chain",)),
        ("fused_attention_block[bwd,saved qkv]",
         lambda: attn_back(K.CUDA, True), lambda: attn_back(K.PLAIN, True),
         grads),
        ("fused_attention_block[bwd,recomputed qkv]",
         lambda: attn_back(K.CUDA, False), lambda: attn_back(K.PLAIN, False),
         grads),
        ("fused_mlp_block[bwd]",
         lambda: fm._backward(K.CUDA, do, x, *mlp[:-1]),
         lambda: fm._backward(K.PLAIN, do, x, *mlp[:-1]), grads),
    ]


def phase_kernels(device):
    errors = {}
    for b, n, tag in ((64, N, "B=64,N=197"), (3, 50, "B=3,N=50")):
        xi, ai, mi, ci = int8_block_inputs(b, n, seed=b * 1000 + n + 1,
                                           device=device)
        cases = ([c[:4] + (INT8_SAME,)
                  for c in int8_kernel_cases(xi, ai, mi, ci)]
                 + [c + (INT8_CHAIN_SAME,)
                    for c in int8_op_cases(xi, ai, mi, ci)])
        for name, kernel, plain, step, same in cases:
            steps = INT8_STEPS if same == INT8_SAME else INT8_CHAIN_STEPS
            max_abs, of_bar = compare_grid(f"{name} {tag}", kernel(),
                                           plain(), step, same, steps)
            print(f"kernels: {name} {tag} max_abs {max_abs:.6g}, "
                  f"{of_bar:.4f} of the bar (int8 grid, step {step:.6g}, "
                  f">= {same} identical, <= {steps} steps)")
            key = name.split("[")[0]
            if b == 64:
                errors[key] = max(errors.get(key, 0.0), max_abs)
        del xi, ai, mi, ci
        x, attn, mlp, do = block_inputs(b, n, seed=b * 1000 + n,
                                        device=device)
        cases = ([c[:4] for c in kernel_cases(x, attn, mlp, do)]
                 + op_cases(x, attn, mlp, do))
        for name, kernel, plain, kinds in cases:
            outs, refs = as_tuple(kernel()), as_tuple(plain())
            check(len(outs) == len(refs) == len(kinds),
                  f"{name}: {len(outs)} outputs")
            worst = (0.0, 0.0)
            for i, (got, ref, kind) in enumerate(zip(outs, refs, kinds)):
                max_abs, of_bar = compare(f"{name} {tag} output {i}", got,
                                          ref, *bar(kind, ref))
                worst = max(worst, (of_bar, max_abs))
            print(f"kernels: {name} {tag} max_abs {worst[1]:.6g}, "
                  f"{worst[0]:.4f} of the bar (kinds {'/'.join(kinds)})")
            key = name.split("[")[0]
            if b == 64:
                errors[key] = max(errors.get(key, 0.0), worst[1])
    print(f"kernels: all within their bars (|d| <= {RTOL:g}*|ref| + atol; "
          f"atol {KERNEL_ATOL:g} kernel, {CHAIN_ATOL:g} chain, "
          f"{SUM_ATOL:g}*max|ref| sum; psum |d| <= {PSUM_ATOL:g}*max|ref|; "
          f"INT8: >= {INT8_SAME} identical and <= {INT8_STEPS} grid steps, "
          f"a chain {INT8_CHAIN_SAME} and {INT8_CHAIN_STEPS})")
    return errors


def smoke_state_dict(model, seed):
    """Reference-named weights from a numpy seed: Linear U(+-1/sqrt(fan_in))
    as the JAX initialiser, LayerNorm 1 + noise, tokens N(0, 0.02^2) as
    timm initialises them (small tokens let the image, not the cls token,
    set the logits, which widens the top-1 margins)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("norm.weight"):
            arr = 1 + 0.1 * rng.randn(*shape)
        elif name.endswith("norm.bias"):
            arr = 0.1 * rng.randn(*shape)
        elif t.dim() == 2:
            bound = shape[1] ** -0.5
            arr = rng.uniform(-bound, bound, shape)
        else:
            arr = 0.02 * rng.randn(*shape)
        sd[name] = torch.from_numpy(arr.astype(np.float32))
    return sd


def write_json(name, obj):
    path = os.path.join(WORK, name)
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def make_dataset():
    """The synthetic RESISC-layout dataset (10 classes, 60 images each:
    420 train, 60 val, 120 test) and its data config at 224 px."""
    os.makedirs(WORK, exist_ok=True)
    data = os.path.join(WORK, "data")
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "classification",
                                      "prepare_synthetic.py"),
         "--out", data, "--per_class", "60", "--seed", "7"],
        check=True, capture_output=True,
    )
    with open(os.path.join(ROOT, "classification", "data_configs",
                           "data_config_synth.json")) as f:
        data_config = json.load(f)
    data_config["dataset_path"] = data
    data_config["transform_ops_train"]["RandomResizedCrop"] = 224
    data_config["transform_ops_val"]["Resize"] = 224  # 96 px -> 224
    return data_config, write_json("data_config.json", data_config)


def vit_small_config():
    with open(os.path.join(ROOT, "classification", "train_configs",
                           "vit_small.json")) as f:
        return json.load(f)


def phase_main(device, data_config, data_cfg):
    from myrtle_vision_tpu_torch.classification import test as cli
    from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config

    config = vit_small_config()
    ckpt = os.path.join(WORK, "vit_small_seed0.pth")
    config["data_config_path"] = data_cfg
    config["train_config"].update(checkpoint_path=ckpt, local_batch_size=32,
                                  drop_last_batch=False)
    cfg = write_json("vit_small_smoke.json", config)
    template = ViT(**vit_kwargs_from_config(config, data_config))
    torch.save(smoke_state_dict(template, seed=0), ckpt)
    depth = config["vit_config"]["depth"]

    reset_counts()
    gts, preds, logits = cli.main(["-c", cfg, "--device", "cuda"])
    launches, ops = read_counts()
    op_launches = (ops["fused_attention_block"][0], ops["fused_mlp_block"][0])
    n_img = len(gts)
    batches = math.ceil(n_img / 32)
    print(f"main: ViT-S/16 eval CLI on cuda, {n_img} images in {batches} "
          f"batches: fused_attention_block {op_launches[0]} launches, "
          f"fused_mlp_block {op_launches[1]}, kernels {launches}")
    check(ops["int8_attention_block"] == ops["int8_mlp_block"] == (0, 0),
          f"op launches {ops}")
    check(op_launches == (depth * batches, depth * batches),
          f"op launches {op_launches}, expected {depth} per batch")
    check(launches == {"layernorm_rows": 2 * depth * batches,
                       "gemm_bf16_epilogue": 4 * depth * batches,
                       "attention_core": depth * batches,
                       "attention_core_bwd": 0, "layernorm_rows_bwd": 0,
                       "colsum_rows": 0, "layernorm_quant_rows": 0,
                       "gemm_s8_epilogue": 0, "attention_core_f32": 0},
          f"kernel launches {launches}")
    check(logits.shape == (n_img, data_config["number_of_classes"]),
          f"logits shape {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "non-finite logits")

    # the same model and batches through the plain versions, on the card
    with open(cfg) as f:
        config = json.load(f)
    model, loader, _ = cli.build_eval(config, device)
    model.eval()
    with torch.inference_mode():
        _, plain_preds, plain_logits = cli.evaluate_dataset(
            lambda images: model(images, plain=True).float(), loader)
    diff = (logits - plain_logits).abs().max().item()
    limit = LOGIT_BAR * max(1.0, plain_logits.abs().max().item())
    agree = float(np.mean(preds == plain_preds))
    print(f"main: kernel vs plain logits max_abs {diff:.6g} (bar "
          f"{limit:.6g}), argmax agreement {agree:.4f} (bar {ARGMAX_BAR})")
    check(diff <= limit and agree >= ARGMAX_BAR,
          "kernel-path logits disagree with the plain path")


def first_step_check(model, train_loader, init_ckpt, n_accum, micro,
                     first_loss):
    """The train CLI's first step again, from its iteration-0 checkpoint
    and its first batch (``model`` and ``train_loader`` as the CLI's
    ``build_train`` sets them up), on the kernel path and on the plain
    path."""
    from myrtle_vision_tpu_torch.training.optim import cross_entropy_loss
    from myrtle_vision_tpu_torch.utils.convert import (
        load_reference_checkpoint,
    )

    epoch = train_loader.epoch(0)
    batch = next(epoch)
    epoch.close()
    model.load_state_dict(load_reference_checkpoint(init_ckpt), strict=True)
    runs = {}
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        loss_sum = 0.0
        for i in range(n_accum):
            sl = slice(i * micro, (i + 1) * micro)
            loss = cross_entropy_loss(model(batch["image"][sl], plain=plain),
                                      batch["label"][sl])
            loss.backward()
            loss_sum += loss.item()
        runs[plain] = (loss_sum / n_accum,
                       {n: p.grad.clone() for n, p in model.named_parameters()
                        if p.grad is not None})
    (k_loss, k_grads), (p_loss, p_grads) = runs[False], runs[True]
    loss_diff = abs(k_loss - p_loss)
    worst, worst_name = 0.0, ""
    for name, ref in p_grads.items():
        got = k_grads[name]
        check(bool(torch.isfinite(got).all()), f"non-finite grad {name}")
        rel = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    print(f"train: first step, kernel vs plain path on the card: loss "
          f"{k_loss:.6f} vs {p_loss:.6f} (|d| {loss_diff:.3g}, bar "
          f"{LOSS_BAR * max(1.0, abs(p_loss)):.3g}; the CLI printed "
          f"{first_loss}), largest relative gradient error {worst:.4g} in "
          f"{worst_name} (bar {GRAD_BAR:g}) over {len(p_grads)} tensors")
    # the same step as the CLI's: its printed loss, to the printed digits
    check(abs(k_loss - first_loss) <= 1e-4,
          f"the recomputed first step ({k_loss}) is not the CLI's "
          f"({first_loss})")
    check(loss_diff <= LOSS_BAR * max(1.0, abs(p_loss)),
          "first-step loss: kernel path disagrees with the plain path")
    check(worst <= GRAD_BAR,
          "first-step gradients: kernel path disagrees with the plain path")


def phase_train(device, data_config, data_cfg):
    """The ViT-S/16 train CLI through the kernels; returns the kernel
    launches of its run."""
    from myrtle_vision_tpu_torch.classification import test as eval_cli
    from myrtle_vision_tpu_torch.classification import train as train_cli

    config = vit_small_config()
    tc = config["train_config"]
    # one epoch from scratch at the config's peak LR, so the steps move the
    # weights; a checkpoint and a validation every 3 steps
    tc.update(output_directory=os.path.join(WORK, "train"),
              checkpoint_path="", epochs=1, warmup_epochs=0,
              pretrained_backbone=None, iters_per_checkpoint=3,
              iters_per_val=3)
    config["data_config_path"] = data_cfg
    cfg = write_json("vit_small_train.json", config)
    depth = config["vit_config"]["depth"]

    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = train_cli.main(["-c", cfg, "--device", "cuda"])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("Iteration", "Epoch", "WARNING")):
            print(f"train: {line}")
    steps = state.iteration
    losses = [float(v) for v in
              re.findall(r"Iteration \d+:\tloss=(\S+)\tacc=", text)]
    # the CLI's set-up again: model, loaders and micro-batching
    with contextlib.redirect_stdout(io.StringIO()):
        model, train_loader, val_loader, (micro, n_accum) = \
            train_cli.build_train(config, device)
    val_batches = len(val_loader)
    validations = len(range(0, steps, tc["iters_per_val"]))
    bwd = depth * n_accum * steps
    fwd = bwd + depth * validations * val_batches
    print(f"train: ViT-S/16 train CLI on cuda, {steps} steps of {n_accum} x "
          f"{micro} images and {validations} validations of {val_batches} "
          f"batch in {took:.1f} s: op launches (forward, backward) {ops}, "
          f"expected ({fwd}, {bwd}) each; kernels {launches}")
    check(steps >= 3 and len(losses) == steps, f"{steps} steps, {losses}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    for op in ("fused_attention_block", "fused_mlp_block"):
        check(ops[op] == (fwd, bwd), f"{op} launches {ops[op]}")
    check(all(launches[k] > 0 for k in FP32_KERNELS),
          f"a kernel never launched: {launches}")

    run_dir = sorted(glob.glob(tc["output_directory"] + "_*"))[-1]
    ckpts = sorted(os.listdir(run_dir))
    check(ckpts == [f"vit_{i:06}" for i in range(0, steps, 3)]
          + [f"vit_{steps:06}"], f"checkpoints {ckpts}")
    first_step_check(model, train_loader, os.path.join(run_dir, "vit_000000"),
                     n_accum, micro, losses[0])
    del model, train_loader, val_loader

    # the last checkpoint, as written, through the eval CLI
    tc["checkpoint_path"] = os.path.join(run_dir, ckpts[-1])
    cfg = write_json("vit_small_trained_eval.json", config)
    with open(os.path.join(data_config["dataset_path"],
                           data_config["test_files"])) as f:
        test_batches = len(f.read().split()) // micro
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        gts, preds, logits = eval_cli.main(["-c", cfg, "--device", "cuda"])
    _, ops_eval = read_counts()
    print(f"train: checkpoint {ckpts[-1]} through the eval CLI: "
          f"{len(gts)} test images, accuracy "
          f"{float(np.mean(gts == preds)):.4f}, op launches {ops_eval}")
    check(logits.shape == (test_batches * micro,
                           data_config["number_of_classes"])
          and bool(torch.isfinite(logits).all()), "eval of the checkpoint")
    check(ops_eval["fused_attention_block"] == (depth * test_batches, 0),
          f"eval launches {ops_eval}")
    return launches


def phase_quantize(device, data_config, data_cfg):
    """The PTQ CLI on vit_small.json in PyTorchINT8 through the INT8
    kernels; returns (kernel launches of its run, the converted
    checkpoint's path, the model's constructor kwargs)."""
    from myrtle_vision_tpu_torch.classification import test_quantize as cli
    from myrtle_vision_tpu_torch.classification.test import evaluate_dataset
    from myrtle_vision_tpu_torch.models.vit import ViT
    from myrtle_vision_tpu_torch.utils.convert import (
        load_reference_checkpoint,
    )

    config = vit_small_config()
    config["vit_config"]["q_format"] = "PyTorchINT8"
    fp32_ckpt = os.path.join(WORK, "vit_small_seed0.pth")  # phase 4's
    saved = os.path.join(WORK, "vit_small_int8_converted.pth")
    config["data_config_path"] = data_cfg
    config["train_config"].update(checkpoint_path=fp32_ckpt,
                                  local_batch_size=32, drop_last_batch=False)
    cfg = write_json("vit_small_int8.json", config)
    depth = config["vit_config"]["depth"]

    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        gts, preds, logits = cli.main(["-c", cfg, "--device", "cuda",
                                       "--calib_steps", "2",
                                       "--save_converted", saved])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        if "calibration" in line or "size" in line or "checkpoint" in line:
            print(f"quantize: {line.strip()}")
    n_img = len(gts)
    batches = math.ceil(n_img / 32)
    int8_ops = (ops["int8_attention_block"][0], ops["int8_mlp_block"][0])
    print(f"quantize: ViT-S/16 PTQ CLI (PyTorchINT8) on cuda in {took:.1f} s,"
          f" {n_img} test images in {batches} batches, accuracy "
          f"{float(np.mean(gts == preds)):.4f}: int8_attention_block "
          f"{int8_ops[0]} launches, int8_mlp_block {int8_ops[1]}, kernels "
          f"{launches}")
    check(int8_ops == (depth * batches, depth * batches),
          f"INT8 op launches {int8_ops}, expected {depth} per batch")
    # per batch: 2 LayerNorms per block and the head's; 4 products per
    # block, the patch embedding and the head; one core per block
    expect = {k: 0 for k in KERNELS}
    expect.update(layernorm_quant_rows=(2 * depth + 1) * batches,
                  gemm_s8_epilogue=(4 * depth + 2) * batches,
                  attention_core_f32=depth * batches)
    check(launches == expect, f"kernel launches {launches}, expected {expect}")
    check(logits.shape == (n_img, data_config["number_of_classes"])
          and bool(torch.isfinite(logits).all()), "converted logits")
    ratio = os.path.getsize(saved) / os.path.getsize(fp32_ckpt)
    print(f"quantize: converted checkpoint {os.path.getsize(saved)} bytes, "
          f"{ratio:.4f} of the fp32 file (bar 0.45)")
    check(ratio < 0.45, "the converted checkpoint is not int8-sized")

    # the written checkpoint, read as it is, through the plain versions
    with open(cfg) as f:
        config = json.load(f)
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, test_loader, _, kwargs = cli.build_quantize(config, device)
    model = ViT(**dict(kwargs, converted=True), device=device)
    model.load_state_dict(load_reference_checkpoint(saved), strict=True)
    model.eval()
    with torch.inference_mode():
        _, plain_preds, plain_logits = evaluate_dataset(
            lambda images: model(images, plain=True), test_loader)
    step = float(model.io_sites[3][0])  # the head's output grid
    stage_check(model, test_loader)
    diff = (logits - plain_logits).abs()
    limit = INT8_LOGIT_BAR * max(1.0, plain_logits.abs().max().item())
    agree = float(np.mean(preds == plain_preds))
    print(f"quantize: kernel vs plain converted logits max_abs "
          f"{diff.max().item():.6g} ({diff.max().item() / step:.3g} steps of "
          f"the head's grid {step:.6g}; bar {limit:.6g}), "
          f"{(diff == 0).float().mean().item():.4f} of them identical, "
          f"argmax agreement {agree:.4f} (bar {INT8_ARGMAX_BAR})")
    check(diff.max().item() <= limit and agree >= INT8_ARGMAX_BAR,
          "converted kernel-path logits disagree with the plain path")
    return launches, saved, kwargs


def stage_check(model, loader):
    """The converted model's forward on the first test batch, stage by
    stage, each stage of the kernel path fed the plain path's input."""
    from myrtle_vision_tpu_torch.ops import _kernels as K

    epoch = loader.epoch(0)
    img = next(epoch)["image"]
    epoch.close()
    worst = (0.0, "")
    with torch.inference_mode():
        x = model.embed_converted(img, K.PLAIN)
        got = model.embed_converted(img, K.CUDA)
        stages = [("embedding", got, x, float(model.pos_embedding_add
                                              .int8_qparams()[0]),
                   INT8_SAME)]
        for i, (block, sites) in enumerate(zip(model.transformer.layers,
                                               model.block_sites)):
            y = block.forward_converted(x, sites, plain=True)
            stages.append((f"block {i}", block.forward_converted(x, sites),
                           y, float(sites[1][4][0]), INT8_CHAIN_SAME))
            x = y
        io, has = model.io_sites, model._has[1]
        stages.append(("head", model.decoder.forward_converted(
            K.CUDA, x, io[2:], has), model.decoder.forward_converted(
            K.PLAIN, x, io[2:], has), float(io[3][0]), INT8_CHAIN_SAME))
        for name, got, ref, step, same in stages:
            steps = INT8_STEPS if same == INT8_SAME else INT8_CHAIN_STEPS
            max_abs, of_bar = compare_grid(f"converted {name}", got, ref,
                                           step, same, steps)
            differ = (got != ref).float().mean().item()
            print(f"quantize: stage {name}: {max_abs / step:.3g} steps of "
                  f"{step:.6g} at most, {differ:.5f} of the elements differ "
                  f"(bar {1 - same:g}, {steps} steps)")
            worst = max(worst, (of_bar, name))
    print(f"quantize: the converted forward stage by stage (embedding, "
          f"{len(model.transformer.layers)} blocks, head), kernel path fed "
          f"the plain path's input: worst {worst[0]:.4f} of the bar, at "
          f"{worst[1]}")


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(kernel, plain, iters=20, warmup=3):
    """plain, kernel, kernel, plain; the mean of each pair."""
    p1, k1, k2, p2 = (cuda_ms(f, iters, warmup)
                      for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def time_case(totals, name, kernel, plain, count, c, power, tag):
    """Kernel and plain ms of one case (paired), its yardstick's ms, its
    bound; added, times ``count``, to its kernel's totals; returns
    (bound ms, yardstick ms or None)."""
    k_ms, p_ms = paired_ms(kernel, plain)
    lib_ms = None if c["library"] is None else cuda_ms(c["library"])
    b_ms, by = bound(c)
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    print(f"timing: {name} {tag} kernel {k_ms:.4f} ms plain {p_ms:.4f} ms, "
          f"library {lib}, bound {b_ms:.4f} ms ({by}: {c['bytes']} bytes, "
          f"{c['ops']} {c['peak']} ops), {count} per block [{power}]")
    acc = totals.setdefault(name.split("[")[0], {
        "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
        "by": {"bytes": 0.0, "operations": 0.0}})
    acc["ms"] += count * k_ms
    acc["plain_ms"] += count * p_ms
    acc["bound_ms"] += count * b_ms
    acc["by"][by] += count * b_ms
    if lib_ms is None or acc["library_ms"] is None:
        acc["library_ms"] = None
    else:
        acc["library_ms"] += count * lib_ms
    return b_ms, lib_ms


def time_chain(cases, name, kernel, plain, power, tag):
    """A block-half chain: paired kernel and plain ms, and for the TPU
    kernel it replaces, the kernel launches of one call and the sums of
    its cases' bounds and yardsticks."""
    k_ms, p_ms = paired_ms(kernel, plain)
    reset_counts()
    kernel()
    launches = {k: v for k, v in read_counts()[0].items() if v}
    line = (f"timing: {name} {tag} kernel chain {k_ms:.4f} ms plain "
            f"{p_ms:.4f} ms [{power}]")
    for tpu, (chain, parts) in TPU_CHAINS.items():
        if chain == name:
            b_ms = sum(cases[p][0] for p in parts)
            libs = [cases[p][1] for p in parts if cases[p][1] is not None]
            missing = [p for p in parts if cases[p][1] is None]
            line += (f"; {tpu}: launches {launches}, bound {b_ms:.4f} ms, "
                     f"yardsticks {sum(libs):.4f} ms"
                     + (f" (none for {', '.join(missing)})" if missing
                        else ""))
    print(line)


def phase_timing(device, power, int8_ckpt, int8_kwargs):
    """Per kernel: {ms, plain_ms, bound_ms, by, library_ms}, each the sum
    over the kernel's launches in one ViT-S/16 block at batch 256: a train
    step (forward with the saved statistics, backward) for the FP32
    kernels, a converted forward for the INT8 ones."""
    from myrtle_vision_tpu_torch.models.vit import ViT
    from myrtle_vision_tpu_torch.training.classification import make_loss_fn
    from myrtle_vision_tpu_torch.training.optim import (
        create_optimizer,
        cross_entropy_loss,
    )
    from myrtle_vision_tpu_torch.training.trainer import (
        TrainState,
        make_train_step,
    )
    from myrtle_vision_tpu_torch.utils.convert import (
        load_reference_checkpoint,
    )

    b = 256
    tag = f"B={b} N={N}"
    totals, cases = {}, {}
    xi, ai, mi, ci = int8_block_inputs(b, N, seed=257, device=device)
    for name, kernel, plain, _, count, c in int8_kernel_cases(xi, ai, mi, ci):
        cases[name] = time_case(totals, name, kernel, plain, count, c, power,
                                tag + " (converted forward)")
    for name, kernel, plain, _ in int8_op_cases(xi, ai, mi, ci):
        time_chain(cases, name, kernel, plain, power, tag)
    del xi, ai, mi, ci
    x, attn, mlp, do = block_inputs(b, N, seed=256, device=device)
    for name, kernel, plain, _, count, c in kernel_cases(x, attn, mlp, do):
        if "other layout" in name:
            continue
        cases[name] = time_case(totals, name, kernel, plain, count, c, power,
                                tag + " (train step)")
    for name, kernel, plain, _ in op_cases(x, attn, mlp, do):
        time_chain(cases, name, kernel, plain, power, tag)
    del x, attn, mlp, do

    model = ViT("classification", 224, 16, 45, 384, 12, 6, 1536,
                device=device)
    gen = torch.Generator(device).manual_seed(0)
    imgs = torch.randn(b, 224, 224, 3, device=device, generator=gen)
    model.eval()
    with torch.inference_mode():
        k_ms, p_ms = paired_ms(lambda: model(imgs),
                               lambda: model(imgs, plain=True))
    print(f"timing: ViT-S/16 forward B={b}: kernel path {k_ms:.3f} ms = "
          f"{b / k_ms * 1e3:.1f} img/s, plain path {p_ms:.3f} ms = "
          f"{b / p_ms * 1e3:.1f} img/s [{power}]")
    bf16_ips = b / k_ms * 1e3

    # the converted model of phase 6, calibrated on the synthetic images
    conv = ViT(**dict(int8_kwargs, converted=True), device=device)
    conv.load_state_dict(load_reference_checkpoint(int8_ckpt), strict=True)
    conv.eval()
    with torch.inference_mode():
        k_ms, p_ms = paired_ms(lambda: conv(imgs),
                               lambda: conv(imgs, plain=True), iters=10)
    print(f"timing: converted INT8 ViT-S/16 forward B={b}: kernel path "
          f"{k_ms:.3f} ms = {b / k_ms * 1e3:.1f} img/s, plain path "
          f"{p_ms:.3f} ms = {b / p_ms * 1e3:.1f} img/s; bf16 forward of "
          f"this run {bf16_ips:.1f} img/s [{power}]")
    del conv

    # one train step (forward, backward, AdamW) on one micro-batch of 256
    tc = vit_small_config()["train_config"]
    state = TrainState(model, create_optimizer(tc, model))
    batch = {"image": imgs[None],
             "label": torch.randint(0, 45, (1, b), device=device,
                                    generator=gen)}

    def plain_loss(mb):
        logits = model(mb["image"], plain=True)
        return cross_entropy_loss(logits, mb["label"]), {"metrics": {}}

    kernel_step = make_train_step(make_loss_fn(model), 1)
    plain_step = make_train_step(plain_loss, 1)
    torch.cuda.reset_peak_memory_stats()
    k_ms, p_ms = paired_ms(lambda: kernel_step(state, batch, tc["lr"]),
                           lambda: plain_step(state, batch, tc["lr"]),
                           iters=5, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"timing: ViT-S/16 train step B={b} (forward, backward, AdamW): "
          f"kernel path {k_ms:.3f} ms = {b / k_ms * 1e3:.1f} img/s, plain "
          f"path {p_ms:.3f} ms = {b / p_ms * 1e3:.1f} img/s, peak device "
          f"memory {peak:.2f} GiB [{power}]")
    return totals


def main():
    require_cuda()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_device()
    phase_build()
    errors = phase_kernels(device)
    data_config, data_cfg = make_dataset()
    phase_main(device, data_config, data_cfg)
    launches = phase_train(device, data_config, data_cfg)
    int8_launches, int8_ckpt, int8_kwargs = phase_quantize(
        device, data_config, data_cfg)
    power = power_line()
    totals = phase_timing(device, power, int8_ckpt, int8_kwargs)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # launches on the path's own run: the train CLI for the FP32
            # kernels, the PTQ CLI for the INT8 ones
            "launches": (int8_launches if name in INT8_KERNELS
                         else launches)[name],
            "max_abs_err": errors[name],
            # sums over this kernel's launches in one ViT-S/16 block at
            # B=256: a train step (FP32 kernels), a converted forward (INT8)
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": max(t["by"], key=t["by"].get),
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(power_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
