#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (myrtle_vision_tpu_torch).

    python3 chip_smoke.py          # from the repository root, one GPU

Phases, each ending in one line of output:
  1. device   the card (torch and nvidia-smi), torch / CUDA / nvcc versions
  2. build    csrc/*.cu compiled for sm_90a into the git-ignored build dir
  3. kernels  each CUDA kernel, forward and backward, and each block-half
              chain, forward and backward, against its plain PyTorch
              version on the card, bf16, ViT-S/16 shapes (B=64, N=197,
              C=384, 6 heads, MLP 1536) and a ragged case (B=3, N=50)
  4. main     the ViT-S/16 eval CLI on a synthetic RESISC-layout dataset
              with seeded random weights: launch counts, logits of the
              kernel path against the plain path
  5. train    the ViT-S/16 train CLI (classification/train_configs/
              vit_small.json: local batch 32, 2 micro-batches per step) for
              one epoch of the same dataset at 224 px: launch counts of
              every block's forward and backward, finite losses, the first
              step's loss and gradients against the plain path, and the
              written checkpoint through the eval CLI
  6. timing   CUDA-event times at batch 256: each kernel, forward and
              backward, and each chain against its plain version, the
              whole-model forward and one train step in images per second
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

# the TPU kernels these CUDA kernels replace (file:line of the Pallas body)
TPU_ATTN = "myrtle_vision_tpu/ops/fused_attention_block.py:196"
TPU_MLP = "myrtle_vision_tpu/ops/fused_mlp.py:159"
TPU_ATTN_BWD = "myrtle_vision_tpu/ops/fused_attention_block.py:370"
TPU_MLP_BWD = "myrtle_vision_tpu/ops/fused_mlp.py:215"
CSRC = "myrtle_vision_tpu_torch/csrc/"
ALL_FOUR = f"{TPU_ATTN}; {TPU_MLP}; {TPU_ATTN_BWD}; {TPU_MLP_BWD}"
KERNELS = {
    "layernorm_rows": (CSRC + "layernorm_rows.cu", ALL_FOUR),
    "gemm_bf16_epilogue": (CSRC + "gemm_bf16_epilogue.cu", ALL_FOUR),
    "attention_core": (CSRC + "attention_core.cu", TPU_ATTN),
    "attention_core_bwd": (CSRC + "attention_core_bwd.cu", TPU_ATTN_BWD),
    "layernorm_rows_bwd": (CSRC + "layernorm_rows_bwd.cu",
                           f"{TPU_ATTN_BWD}; {TPU_MLP_BWD}"),
    "colsum_rows": (CSRC + "layernorm_rows_bwd.cu",
                    f"{TPU_ATTN_BWD}; {TPU_MLP_BWD}"),
}


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


def reset_counts():
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.fused_attention_block import (
        fused_attention_block,
    )
    from myrtle_vision_tpu_torch.ops.fused_mlp import fused_mlp_block

    K.reset_launches()
    for op in (fused_attention_block, fused_mlp_block):
        op.launches = op.bwd_launches = 0


def read_counts():
    """(kernel launches, {op: (forward, backward) launches})."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.fused_attention_block import (
        fused_attention_block,
    )
    from myrtle_vision_tpu_torch.ops.fused_mlp import fused_mlp_block

    torch.cuda.synchronize()
    return dict(K.LAUNCHES), {
        "fused_attention_block": (fused_attention_block.launches,
                                  fused_attention_block.bwd_launches),
        "fused_mlp_block": (fused_mlp_block.launches,
                            fused_mlp_block.bwd_launches),
    }


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


def kernel_cases(x, attn, mlp, do):
    """(name, kernel thunk, plain thunk, bar kind of each output, launches
    per block in a train step) for each CUDA kernel at the shapes and
    operand layouts the main path gives it, inputs prepared with the
    plain versions the way the ops prepare them: the forward GEMMs read
    the weights column-major (the (in, out) view of a torch (out, in)
    weight), the backward data-gradient GEMMs row-major.  The other
    layout of each is a check case with count 0 (", other layout").  A
    weight-gradient GEMM's time includes the sum of its split-K partial
    products."""
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
        return (f"gemm_bf16_epilogue[{name}]",
                lambda: gemm[0](*args, **kw), lambda: gemm[1](*args, **kw),
                kinds, count)

    return [
        ("layernorm_rows", lambda: K.layernorm_rows_cuda(x2, s, bi),
         lambda: K.layernorm_rows_plain(x2, s, bi), ("kernel",), 4),
        mm("qkv,bias", (xn, wqkv, bqkv, "bias"), ("kernel",), 1),
        mm("qkv,bias, other layout", (xn, wqkv_o, bqkv, "bias"),
           ("kernel",), 0),
        mm("proj,bias+residual", (ctx, wp, bp, "bias_residual"), ("kernel",),
           1, residual=x2),
        mm("fc1,bias+gelu", (xn, w1, b1, "bias_gelu"), ("kernel",), 1),
        mm("fc2,bias+residual", (g, w2, b2, "bias_residual"), ("kernel",), 1,
           residual=x2),
        ("attention_core", lambda: K.attention_core_cuda(qkv3, HEADS, SCALE),
         lambda: K.attention_core_plain(qkv3, HEADS, SCALE), ("kernel",), 0),
        ("attention_core[stats]",
         lambda: K.attention_core_cuda(qkv3, HEADS, SCALE, stats=True),
         lambda: K.attention_core_plain(qkv3, HEADS, SCALE, stats=True),
         ("kernel", "kernel", "kernel"), 1),
        # backward
        mm("d_o=do.Wp^T,f32", (do2, wp.t(), None, "f32"), ("kernel",), 1),
        mm("d_o=do.Wp^T,f32, other layout", (do2, wp_o.t(), None, "f32"),
           ("kernel",), 0),
        ("attention_core_bwd",
         lambda: K.attention_core_bwd_cuda(qkv3, d_o.view(b, n, C), m, rs,
                                           HEADS, SCALE),
         lambda: K.attention_core_bwd_plain(qkv3, d_o.view(b, n, C), m, rs,
                                            HEADS, SCALE),
         ("chain", "psum"), 1),
        ("colsum_rows[dbqkv]", lambda: K.colsum_rows_cuda(dbq_image),
         lambda: K.colsum_rows_plain(dbq_image), ("sum",), 1),
        mm("dWp=do^T.ctx,A^T", (do2.t(), ctx, None, "f32"), ("sum",), 1),
        ("colsum_rows[dbp,db2]", lambda: K.colsum_rows_cuda(do2),
         lambda: K.colsum_rows_plain(do2), ("sum",), 2),
        mm("dWqkv=dqkv^T.xn,A^T", (dqkv.t(), xn, None, "f32"), ("sum",), 1),
        mm("dxn=dqkv.Wqkv^T,f32", (dqkv, wqkv.t(), None, "f32"), ("kernel",),
           1),
        mm("dxn=dqkv.Wqkv^T,f32, other layout",
           (dqkv, wqkv_o.t(), None, "f32"), ("kernel",), 0),
        ("layernorm_rows_bwd",
         lambda: K.layernorm_rows_bwd_cuda(x2, s, dxn, do2),
         lambda: K.layernorm_rows_bwd_plain(x2, s, dxn, do2),
         ("kernel", "sum", "sum"), 2),
        mm("fc1 remat,bias+gelu+gelu'", (xn, w1, b1, "bias_gelu_grad"),
           ("kernel", "kernel"), 1),
        mm("dW2=do^T.g,A^T", (do2.t(), g_r, None, "f32"), ("sum",), 1),
        mm("dh=do.W2^T*gelu',colsum", (do2, w2.t(), None, "mul_aux"),
           ("kernel", "sum"), 1, aux=gp),
        mm("dW1=dh^T.xn,A^T", (dh.t(), xn, None, "f32"), ("sum",), 1),
        mm("dxn=dh.W1^T,f32", (dh, w1.t(), None, "f32"), ("kernel",), 1),
    ]


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
          f"{SUM_ATOL:g}*max|ref| sum; psum |d| <= {PSUM_ATOL:g}*max|ref|)")
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
    check(op_launches == (depth * batches, depth * batches),
          f"op launches {op_launches}, expected {depth} per batch")
    check(launches == {"layernorm_rows": 2 * depth * batches,
                       "gemm_bf16_epilogue": 4 * depth * batches,
                       "attention_core": depth * batches,
                       "attention_core_bwd": 0, "layernorm_rows_bwd": 0,
                       "colsum_rows": 0},
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
    for op, counts in ops.items():
        check(counts == (fwd, bwd), f"{op} launches {counts}")
    check(all(n > 0 for n in launches.values()),
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


def phase_timing(device, power):
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

    b = 256
    x, attn, mlp, do = block_inputs(b, N, seed=256, device=device)
    per_block = {}
    for name, kernel, plain, _, count in kernel_cases(x, attn, mlp, do):
        if "other layout" in name:
            continue
        k_ms, p_ms = paired_ms(kernel, plain)
        print(f"timing: {name} B={b} N={N} kernel {k_ms:.4f} ms plain "
              f"{p_ms:.4f} ms, {count} per block and train step [{power}]")
        acc = per_block.setdefault(name.split("[")[0], [0.0, 0.0])
        acc[0] += count * k_ms
        acc[1] += count * p_ms
    for name, kernel, plain, _ in op_cases(x, attn, mlp, do):
        k_ms, p_ms = paired_ms(kernel, plain)
        print(f"timing: {name} B={b} N={N} kernel chain {k_ms:.4f} ms plain "
              f"{p_ms:.4f} ms [{power}]")

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
    return per_block


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
    power = power_line()
    per_block = phase_timing(device, power)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errors[name],
            # time of this kernel's launches in one ViT-S/16 block's train
            # step (forward with the saved statistics, backward), B=256
            "ms": per_block[name][0], "plain_ms": per_block[name][1],
        })
    print(json.dumps({"kernels": kernels}))
    print(power_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
