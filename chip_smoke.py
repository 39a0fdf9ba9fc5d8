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
              a real calibration of the block; the flash-attention forward
              at the detection eval's shapes (YOLOS-S, 800 px: B=8, 6 heads,
              N=2601, the K6 regime; 512 px: N=1125, the K5 regime) and a
              ragged masked case, and the fused attention chain at YOLOS-S
              224 and 384 px (N=297, 677, B=16), longer than one block of
              shared memory holds; the flash-attention backward at the
              detection training's shapes (YOLOS-S at 400, 592, 608 px and
              a 608 x 1008 crop: B=2, N=726, 1470, 1545, 2495; the K8 and
              K7 regimes) and a ragged masked case, and the attention
              core's backward and the whole fused attention backward
              chain at 256 and 384 px (N=357, 677, B=4), each from its own
              path's forward residuals; the float formats' kernels: the
              qtorch fake-quant K11 in its five modes on 2^24 + 7 values
              (bit-identical to its plain version), the LayerNorm, 3-pass
              GEMM and attention-core stages and both block-half chains
              with each qspec (FP16_16, FP16_32, TF32) at B=64, N=197 and
              the ragged B=3, N=50, and 250 calls of the attention chain
              and of its kernels chained by hand in each format, bit for
              bit the first call's (ROADMAP C11); the float formats'
              backward kernels
              (the qspec forms of K2 and K4: the 3-pass GEMM in the
              backward's layouts and epilogues, the snap-mode core's
              statistics, attention_core_f32_bwd, layernorm_snap_rows_bwd)
              and both backward chains, in each format at B=64, N=197; the
              float formats' long core above 256 tokens
              (attention_core_f32_long, attention_core_f32_bwd_long) at N
              = 257, 357, 677, 701, head widths 64 and 32, B = 2 and 8, in
              each format with and without the statistics, and forced at
              B=64, N=197 against the one-CTA kernels; past 768 tokens
              (the forward's cluster design) at N = 769, 1001, 1017 (3
              heads of 64), 1806 (one head of 64) and 1837 (one of 32), B =
              2 and 8, and the cluster design forced at N = 257-768
              against the score-block design
  3a. kernels-f32  float32 compute (compute_dtype float32): the fp32 flash
              forward (K5 / K6 on fp32 operands, 3xTF32 on wgmma, csrc/
              flash_attention_f32_fwd_wgmma.cu) and backward (K7 / K8,
              csrc/flash_attention_f32_bwd_wgmma.cu) against their plain
              versions' true fp32 at YOLOS-S's 800 px (8, 6, 2601, 64) and
              608 px (2, 6, 1545, 64) shapes, ViT-S/16's (64, 6, 197, 64)
              and a ragged masked case, two and four launches a call; the
              fp32 K1-K4 route (the qspec chains with a
              site table that snaps nothing) forward and backward against
              the plain chains' true fp32 at B=64, N=197, B=4, N=677 and
              YOLOS-Ti's B=2, N=1001 (dim 192, 3 heads: the cluster
              long core)
  3b. probes the probes of the port's kernels, K12-K14
              (myrtle_vision_tpu_torch/perf/): every K12 attention-core
              mode and K13 GELU mode in its block chain, and every K14
              layout case, against its plain version at B=64, N=197 and
              B=3, N=50 (K12's "none" through its parts, the undivided
              product and the rowsum); the FP32 chains K1-K4, forward and
              backward, and the K12 / K13 chains at the widths of
              vit_tiny.json (192, 3 heads) and vit_base.json (768, 12
              heads), B=16; then the three probe tools at their default
              shapes (B=512), every count reset just before and read just
              after (their kernels must have launched), each variant's
              plain version, bound and yardstick, and the attribution
              tools train_gap_bench and int8_component_bench at B=256
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
  6b. quantize-float  the same PTQ CLI in FP16_32: 2 calibration batches
              through the simulation forward, convert, the fp16 converted
              checkpoint, the test split through the float-format kernels
              (K11 at the sites outside the blocks, the qspec block-half
              chains); launch counts, the converted forward stage by stage
              and end to end against the plain path
  6c. qat     the ViT-S/16 train CLI in FP16_32 (QAT) for one epoch of
              the same dataset: launch counts of every block half's
              forward and backward, no call of a plain version, finite
              losses, the first step's loss and gradients against the
              plain path, the last checkpoint through the eval CLI
  6d. qat-int8  the PyTorchINT8 QAT kernels and ops against their plain
              versions (each kernel's int8-site mode forward and backward,
              both ops' chains, at B=64, N=197 with calibrated sites and
              with a site that has no statistics), then the ViT-S/16 train
              CLI in PyTorchINT8 (the two-pass QAT step) for one epoch of
              the same dataset: launches of both INT8 QAT ops, forward and
              backward, no call of a plain version, the first step against
              the plain path, the last checkpoint through the eval CLI
              (the INT8 simulation) and the PTQ CLI (convert, the
              converted K9 / K10 forward): both accuracies and the share
              of agreeing argmaxes
  6e. int8-long  PyTorchINT8 above 256 tokens: the long fp32 core's two
              int8 modes (the INT8 QAT site snap with and without the
              statistics, the converted model's int8 grid) against their
              plain versions at B=8 N=577 (ViT-S/16 at 384 px), B=2 N=677
              and 701 (YOLOS-S at 384 px, the fused gate), and past 768
              tokens at the cluster cases of phase 3, with each flip
              share, and forced at B=64 N=197 against the one-CTA kernel;
              the INT8 QAT attention op forward and backward (K1 / K2
              int8) and the converted halves (K9 / K10) at B=8 N=577
  6f. int8-384  ViT-S/16 at 384 px (577 tokens) in PyTorchINT8: the train
              CLI (the two-pass QAT step, pass 2 through the long core's
              site mode) for one epoch of a 350-image synthetic set, its
              launches, the first step against the plain path; its last
              checkpoint through the PTQ CLI (the converted K9 / K10
              forward, the core in the long core's int8 mode), launches,
              stage by stage and end to end against the plain path
  7. detect   the YOLOS-S detection eval CLI (detection/test.py's path;
              detection/train_configs/yolos_small.json, local batch 2) on
              the synthetic DIOR-layout test split (96 images, 160 px)
              with DIOR's test transform (resize to 800 px: 2601 tokens)
              and seeded random weights: flash launches (12 per batch), the
              COCO summary, outputs of the kernel path against the plain
              path on the same batches
  8. detect-train  the YOLOS-S detection train CLI (detection/train.py's
              path; yolos_small.json, 2 micro-batches of 2 per step) for one
              epoch of a subset of the synthetic DIOR-layout train split
              with DIOR's train transform (256-608 px, crops), then COCO
              validation at 800 px: finite losses, the launches of the
              flash backward and the long attention backward against the
              canvases the epoch drew, vit_best through the detection eval
              CLI; then, at forced canvases of 384, 512 and 608 px (the
              fused long backward, K8, K7), the first step's loss and every
              gradient, kernel path against plain path
  8b. detect-float  YOLOS-S in FP16_32 (yolos_small.json with q_format
              FP16_32): the 800 px eval forward at batch 8 (the discrete
              float Block) against the plain path; the first QAT step at
              384 px (677 tokens: the long f32 core, launches counted) and
              608 px (the discrete float Block) against the plain path;
              the train CLI for one epoch of 32 synthetic images at
              288-352 px (425-585 tokens, every step through the long
              core, launches counted), its validation at 800 px, and its
              checkpoint through the detection eval CLI
  8c. detect-int8  YOLOS-S in PyTorchINT8: the train CLI (the one-pass
              QAT step, PyTorch operations as in the JAX package, no kernel
              of the port) for one epoch of 32 synthetic images at 288-352
              px, its validation at 800 px, its checkpoint (observers and
              all) through the detection eval CLI; no launches
  8c2. detect-tiny  the long fp32 core past 768 tokens on the main paths:
              YOLOS-Ti (detection/train_configs/yolos_tiny.json: dim 192,
              3 heads of 64, MLP 768, 100 detection tokens) in FP16_32, the
              first QAT step at 480 and 464 px (1001 and 942 tokens) and
              in float32 compute at 480 px, kernel vs plain; the train CLI
              for 2 steps of 2 x 2 at 480 px and, resumed, 1 at 464 px,
              each validating at its canvas: the long core's launches, no
              plain call; then vit_tiny.json's widths at 480 px (901
              tokens) in PyTorchINT8 through the train CLI (the two-pass
              step) and the PTQ CLI (the converted forward), as int8-384
  8d. seg     DLRSD segmentation on segmentation/train_configs/
              seg_small.json at its full width (ViT-S/16 at 224 px, local
              batch 32, global 64) on prepare_synthetic.py's 5 texture
              classes resized to 224 px, random weights from the seed: the
              FP32 train CLI for 3 steps through the fused K1-K4 chains
              (launches of both ops, forward and backward), the first step
              kernel vs plain; the last checkpoint through the test CLI
              (launches exact, PNGs written), its pixel logits kernel vs
              plain, and exported and imported back by the checkpoint CLIs
              (the same logits bit for bit); the FP16_32 QAT (the qspec
              chains, first step kernel vs plain) and PyTorchINT8 one-pass
              QAT (no kernel) train CLIs for 2 steps each and their
              checkpoints through the test CLI; a timing line (FP32 step
              at 2 x 32, eval forward at B=32, FP16_32 step, a profile)
  8e. distill  DeiT distillation with a CNN teacher on classification/
              train_configs/deit_small.json at its full width (the ViT-S/16
              student, 224 px: 197 tokens and the distillation token, local
              batch 32, global 64): finetune_cnn writes a ResNet-50 teacher
              (He-init, one epoch of the synthetic train split at 224 px,
              batch 32) and test_cnn evaluates it; the teacher on the card
              against the same teacher on the CPU (fp32, TF32 off); the
              train CLI distils for 3 steps of 2 x 32 through the fused
              K1-K4 chains (launches of both ops, forward and backward, and
              the token count of every call: 198, or 197 for the plain
              student's validation accuracy), the first step kernel vs
              plain; the eval CLI on the last checkpoint's student, the
              export CLI's student file through the eval CLI again (the same
              logits bit for bit); a timing line (the distilled step at 2 x
              32, the teacher's share of it, a profile with the idle share)
  8f. fp32    float32 compute through the CLIs at full width: the ViT-S/16
              train CLI (vit_small.json, compute_dtype float32) for 3 steps
              of 2 x 32 through the fused fp32 route, the first step kernel
              vs plain, the eval CLI on its checkpoint; the same train CLI
              under MVT_NO_FUSE=1 (the discrete Blocks, the fp32 flash K5 /
              K8, launches counted), its first step kernel vs plain;
              YOLOS-S (yolos_small.json, float32 compute): the 800 px
              forward (K6 on fp32) and the first 2 x 2 step at 608 px (K6 /
              K7) and 384 px (the long fp32 core), kernel vs plain
  8g. remainder  the port's visualize_attention CLI on phase fp32's and
              phase main's ViT-S/16 checkpoints (a PNG per head and the
              mean, each layer's probabilities, no kernel launched); the
              ViT-S/16 train CLI with dropout and emb_dropout 0.1 for 4
              steps (the Blocks discrete: bf16 flash launches counted) with
              MVT_PROFILE_DIR set (a Chrome trace of steps 3-5 holding the
              card's kernels); the scalars the detection and segmentation
              train CLIs logged (runs/scalars.jsonl)
  9. timing   CUDA-event times at batch 256: each kernel, forward and
              backward (also the profiler's device time, kernel by
              kernel), and each chain against its plain version and,
              where one exists, a PyTorch call of the same function (a
              yardstick the port never calls); the whole-model forward (bf16
              and converted INT8) and one train step in images per second;
              the flash kernel at both regimes' shapes and the YOLOS-S
              detection forward at 800 px, batch 8; the flash backward at
              (8, 6, 1545, 64) and (8, 6, 1125, 64), the long core backward
              at N=677, and the YOLOS-S train step at 608 and 384 px; the
              float formats' kernels and chains in FP16_32 and the
              converted FP16_32 forward; the QAT backward kernels and
              chains in FP16_32 and one FP16_32 QAT train step beside the
              FP32 one (img/s, peak memory, a device profile); the INT8 QAT
              chains per block and the two-pass PyTorchINT8 QAT step (pass
              1, pass 2 and the backward apart, peak memory, a profile);
              the float long core and its backward at N=677, B=8 and 2,
              beside fp32 SDPA; past 768 tokens at (2, 3, 1001, 64), (8, 3,
              1001, 64) and (2, 1, 1837, 32); the YOLOS-Ti FP16_32 QAT step
              at 480 and 464 px and the YOLOS-S one at 608 and 384 px and
              its 800 px forward at batch 8, with device profiles;
              the long core's int8 modes at B=8 N=577 beside the plain
              version, the bound and fp32 SDPA then the quantize, the
              K1 / K2 int8 and K9 / K10 chains there, the 384 px two-pass
              INT8 QAT step (B=256 or the largest half that fits: peak
              memory, the passes apart, a profile) and converted forward,
              and the YOLOS-S INT8 QAT step at 608 and 384 px and its 800
              px forward at batch 8, each with a device profile; the fp32
              flash kernels at K5-K8's shapes beside fp32 SDPA and its
              backward, the fp32 K1-K4 route per ViT-S/16 block at B=256
              beside F.layer_norm, cuBLAS fp32 products and fp32 SDPA, the
              ViT-S/16 float32 step at B=256 (fused and under
              MVT_NO_FUSE=1), the YOLOS-S float32 800 px forward and its
              608 / 384 px steps, with device profiles
  multigpu    multi-GPU training on the one card: the res_scale forms of
              the kernels (head-sharded tensor parallelism's K1-K4) and
              both block-half chains with them against their plain
              versions at n_tp = 2's local widths; the data-parallel
              step over an NCCL group of one against the step without a
              group; two ranks of the classification train CLI over gloo
              (data 2; tensor parallel 2 in bf16 and fp32 compute) and of
              the detection train CLI (YOLOS-S at 384 px, data 2), each
              rank a process launched as a user launches one, against one
              process: first-step losses and gradients, res_scale
              launches; tensor parallel 2 where the fused gate refuses
              (vit_small.json in FP16_32, under MVT_NO_FUSE=1 and in
              PyTorchINT8 QAT; YOLOS-S at 608 px in FP32): the same, the
              whole ops' launches, the discrete attention calls by head
              count, the INT8 observers; the steps' times (two ranks share
              one card: not a scaling figure).  A rank runs this script
              with ``--counted <counts.json> <grads.pt> <CLI module>
              <args>``.
Then the JSON line of kernels, the card's name and power limit, and as
the last line {"ok": true, "device": {...}}.  Any failure raises and
exits non-zero before that line; without a CUDA device it exits at once.
"""
import contextlib
import functools
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

from myrtle_vision_tpu_torch.perf._timing import (
    SFU_EXP_PER_S,
    bound,
    cost,
    cuda_ms,
    kernel_device_ms,
    nbytes,
    power_line,
)

START = time.perf_counter()
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
# Float formats, kernel against plain version: both snap with the same
# code (csrc/fake_quant.cuh against ops/fake_quant.py, bit-identical) at
# the same points, and every other step is the same fp32 operations, but
# for the order of fp32 sums (LayerNorm statistics, the 3-pass products,
# the softmax rowsum) and PyTorch's rewrite of the plain GELU's divide;
# such a difference is fp32 noise (FLOAT_TIGHT of the output's largest
# magnitude) unless it moves a value across a snap's rounding boundary,
# which moves that element by one step of the format, or two where an
# epilogue snaps twice in series (FP16_16's GELU input and output, its
# projection before the residual add and the sum).  Bar, in the INT8
# form: at least FLOAT_SAME of an output's elements within the fp32
# noise, every other one within its steps of the format at the larger
# magnitude of the values snapped in series (FLOAT_SAME: one flipped snap
# site in a thousand, two sites).  A chain carries a flipped element into
# the row of
# every product after it, and through a key or value into every query of
# its image: at least FLOAT_CHAIN_SAME within the noise, none more than
# one step of the format at the output's largest magnitude.  The
# converted model is held stage by stage, each stage fed the plain path's
# input: the embedding to the kernel bar, each block and the head to one
# step at the largest magnitude, with the share past the noise printed but
# not held, since it follows the images (a test batch of the synthetic
# set had 21.9% of block 0's outputs past it, at 0.303 of a step); end to
# end by the FP32 model's logit bar.
FLOAT_TIGHT = 2.0 ** -16
FLOAT_SAME = 0.998
FLOAT_CHAIN_SAME = 0.95
FLOAT_QSPECS = {"FP16_16": (5, 10, True), "FP16_32": (5, 10, False),
                "TF32": (8, 10, False)}
# K11's modes: FloatingPoint (exp, man) and FixedPoint (wl, fl), and the
# number of values each is checked on (2^24 + 7: the 16-byte vectors and
# a ragged tail)
FAKE_QUANT_MODES = [("float", 5, 10), ("float", 8, 10), ("fixed", 11, 9),
                    ("fixed", 11, 8), ("fixed", 11, 7)]
FAKE_QUANT_N = 2 ** 24 + 7
# PyTorchINT8 QAT (phase qat-int8), kernel against plain version: the float
# chains' kernels with the frozen observer sites in place of the float
# snaps, every snap bit-identical to its plain version, every other step
# the same fp32 operations but for the order of fp32 sums.  Such a
# difference is fp32 noise (FLOAT_TIGHT of the output's largest magnitude)
# unless it moves a value across a site's rint edge, which moves that
# element by a whole step of the site's grid (its scale, ~1/255 of the
# site's range).  Bar, per snapped output: at least I8_SAME of its
# elements within the noise, every element within one step of its site;
# where an epilogue snaps twice in series (GELU, the residual sum) a flip
# of the first site, through a slope of at most 1.2 (GELU' < 1.13), reaches
# the second grid as up to ceil(1.2 s1 / s2) + 1 of its steps.  A
# block-half chain: I8_CHAIN_SAME within the noise, every element within
# I8_CHAIN_STEPS steps of the output's site (the converted INT8 chain
# bar).  The unsnapped outputs (the gradients) take the FP32 bars.
I8_SAME = 0.998
I8_CHAIN_SAME = 0.99
I8_CHAIN_STEPS = 4
# the TPU kernels these CUDA kernels replace (file:line of the Pallas body)
TPU_ATTN = "myrtle_vision_tpu/ops/fused_attention_block.py:196"
TPU_MLP = "myrtle_vision_tpu/ops/fused_mlp.py:159"
TPU_ATTN_BWD = "myrtle_vision_tpu/ops/fused_attention_block.py:370"
TPU_MLP_BWD = "myrtle_vision_tpu/ops/fused_mlp.py:215"
TPU_INT8_ATTN = "myrtle_vision_tpu/ops/fused_int8_block.py:161"
TPU_INT8_MLP = "myrtle_vision_tpu/ops/fused_int8_block.py:207"
TPU_FLASH = ("myrtle_vision_tpu/ops/flash_attention.py:127; "
             "myrtle_vision_tpu/ops/flash_attention.py:200")  # K5; K6
TPU_FLASH_BWD = ("myrtle_vision_tpu/ops/flash_attention.py:388; "
                 "myrtle_vision_tpu/ops/flash_attention.py:290")  # K8; K7
TPU_K11 = ("myrtle_vision_tpu/ops/fake_quant.py:131; "
           "myrtle_vision_tpu/ops/fake_quant.py:127")  # float; fixed point
TPU_QSPEC = f"{TPU_ATTN} (qspec); {TPU_MLP} (qspec)"
TPU_QSPEC_BWD = f"{TPU_ATTN_BWD} (qspec); {TPU_MLP_BWD} (qspec)"
CSRC = "myrtle_vision_tpu_torch/csrc/"
ALL_FOUR = f"{TPU_ATTN}; {TPU_MLP}; {TPU_ATTN_BWD}; {TPU_MLP_BWD}"
INT8_BOTH = f"{TPU_INT8_ATTN}; {TPU_INT8_MLP}"
# per kernel: its source and the TPU kernels it replaces; the first six
# run on the FP32 path (phases 4 and 5), the next three on the converted
# INT8 path (phase 6; attention_core_f32 also on the float path, 6b), the
# flash forward on the detection eval (phase 7), the flash backward on the
# detection training (phase 8), the last three on the float path (6b)
KERNELS = {
    "layernorm_rows": (CSRC + "layernorm_rows.cu", ALL_FOUR),
    "gemm_bf16_epilogue": (CSRC + "gemm_bf16_wgmma.cu", ALL_FOUR),
    "attention_core": (CSRC + "attention_core_wgmma.cu", TPU_ATTN),
    "attention_core_bwd": (CSRC + "attention_core_bwd_wgmma.cu",
                           TPU_ATTN_BWD),
    "layernorm_rows_bwd": (CSRC + "layernorm_rows_bwd.cu",
                           f"{TPU_ATTN_BWD}; {TPU_MLP_BWD}"),
    "colsum_rows": (CSRC + "layernorm_rows_bwd.cu",
                    f"{TPU_ATTN_BWD}; {TPU_MLP_BWD}"),
    "layernorm_quant_rows": (CSRC + "layernorm_quant_rows.cu", INT8_BOTH),
    "gemm_s8_epilogue": (CSRC + "gemm_s8_wgmma.cu", INT8_BOTH),
    "attention_core_f32": (CSRC + "attention_core_f32_wgmma.cu",
                           f"{TPU_INT8_ATTN}; {TPU_ATTN} (qspec)"),
    "flash_attention_fwd": (CSRC + "flash_attention_fwd_wgmma.cu",
                            TPU_FLASH),
    "flash_attention_bwd": (CSRC + "flash_attention_bwd_wgmma.cu",
                            TPU_FLASH_BWD),
    "fake_quant_rows": (CSRC + "fake_quant_rows.cu", TPU_K11),
    "layernorm_snap_rows": (CSRC + "layernorm_snap_rows.cu", TPU_QSPEC),
    "gemm_f32x3_epilogue": (CSRC + "gemm_f32x3_wgmma.cu", TPU_QSPEC),
    "attention_core_f32_bwd": (CSRC + "attention_core_f32_bwd_wgmma.cu",
                               f"{TPU_ATTN_BWD} (qspec)"),
    "layernorm_snap_rows_bwd": (CSRC + "layernorm_rows_bwd.cu",
                                TPU_QSPEC_BWD),
    "attention_core_f32_long": (CSRC + "attention_core_f32_long_wgmma.cu",
                                f"{TPU_ATTN} (qspec, above 256 tokens)"),
    "attention_core_f32_bwd_long": (
        CSRC + "attention_core_f32_bwd_long_wgmma.cu",
        f"{TPU_ATTN_BWD} (qspec, above 256 tokens)"),
}
INT8_KERNELS = ("layernorm_quant_rows", "gemm_s8_epilogue",
                "attention_core_f32")
# the discrete attention path's kernels, run by the detection eval (phase 7)
# and the detection training (phase 8)
DETECT_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")
# the float formats' own kernels (phase 6b), and those only their
# backward runs (phase 6c)
FLOAT_KERNELS = ("fake_quant_rows", "layernorm_snap_rows",
                 "gemm_f32x3_epilogue")
QAT_KERNELS = ("attention_core_f32_bwd", "layernorm_snap_rows_bwd")
# the float formats' fp32 core above 256 tokens, forward and backward, run
# by YOLOS-S detection in a float format (phase detect-float)
LONG_FLOAT_KERNELS = ("attention_core_f32_long", "attention_core_f32_bwd_long")
# the same two past 768 tokens (the forward's cluster design and the
# backward past the score block's old top), each a kernels-line entry of
# its own with the launches of phase detect-tiny's train CLI and the
# (2, 3, 1001, 64) timing: (entry, counter, timed case)
SWEEP_KERNELS = (
    ("attention_core_f32_long[cluster]", "attention_core_f32_long",
     "attention_core_f32_long[cluster, B=2 H=3 N=1001 D=64]"),
    ("attention_core_f32_bwd_long[past 768]", "attention_core_f32_bwd_long",
     "attention_core_f32_bwd_long[past 768, B=2 H=3 N=1001 D=64]"))
# the long fp32 core's int8 modes (PyTorchINT8 above 256 tokens, phases
# int8-long and int8-384): the INT8 QAT site snap (K1 int8's core) and the
# converted model's int8 grid (K9's core), each a kernels-line entry of its
# own beside the float mode's
LONG_INT8_KERNELS = {
    "attention_core_f32_long[int8 sites]": f"{TPU_ATTN} (int8, above 256 "
                                           "tokens)",
    "attention_core_f32_long[int8 out]": f"{TPU_INT8_ATTN} (above 256 "
                                         "tokens)"}
# their kernel cases (B, N): ViT-S/16 at 384 px (577 tokens), YOLOS-S at
# 384 px (677) and the fused gate (701)
LONG_INT8_CASES = ((8, 577), (2, 677), (2, 701))
# the batch of the 384 px timings: the two-pass QAT step's first try (it
# halves until the step fits) and the converted forward
INT8_384_BATCH = 256
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
    "K1 qspec": ("fused_attention_block[qspec]", [
        "layernorm_snap_rows", "gemm_f32x3_epilogue[qkv,bias+snap]",
        "attention_core_f32[snap]",
        "gemm_f32x3_epilogue[proj,bias+snap+residual+snap]"]),
    "K3 qspec": ("fused_mlp_block[qspec]", [
        "layernorm_snap_rows", "gemm_f32x3_epilogue[fc1,bias+snap+gelu+snap]",
        "gemm_f32x3_epilogue[fc2,bias+snap+residual+snap]"]),
    "K2 qspec": ("fused_attention_block[qspec,bwd,saved qkv]", [
        "layernorm_snap_rows", "gemm_f32x3_epilogue[d_o=do.Wp^T,f32]",
        "attention_core_f32_bwd", "colsum_rows[dbqkv,fp32]",
        "gemm_f32x3_epilogue[dWp=do^T.ctx,A^T]", "colsum_rows[dbp,db2,fp32]",
        "gemm_f32x3_epilogue[dWqkv=dqkv^T.xn,A^T]",
        "gemm_f32x3_epilogue[dxn=dqkv.Wqkv^T,f32]",
        "layernorm_snap_rows_bwd"]),
    "K4 qspec": ("fused_mlp_block[qspec,bwd]", [
        "layernorm_snap_rows",
        "gemm_f32x3_epilogue[fc1 remat,bias+snap+gelu+snap+gelu']",
        "gemm_f32x3_epilogue[dW2=do^T.g,A^T]", "colsum_rows[dbp,db2,fp32]",
        "gemm_f32x3_epilogue[dh=do.W2^T*gelu',colsum]",
        "gemm_f32x3_epilogue[dW1=dh^T.xn,A^T]",
        "gemm_f32x3_epilogue[dxn=dh.W1^T,f32]", "layernorm_snap_rows_bwd"]),
}
# the INT8 QAT variants of K1-K4: the qspec chains' kernels with the
# observer sites, so the same cases' bounds and yardsticks
for _k in ("K1", "K2", "K3", "K4"):
    _chain, _parts = TPU_CHAINS[f"{_k} qspec"]
    TPU_CHAINS[f"{_k} int8"] = (
        _chain.replace("[qspec,", "_i8[").replace("[qspec]", "_i8"), _parts)
# the four INT8 QAT variants in the kernels line: (its sources, the TPU
# kernel it replaces, the chain's timing name)
_Q_SRC = (f"{CSRC}layernorm_snap_rows.cu; {CSRC}gemm_f32x3_wgmma.cu; "
          f"{CSRC}attention_core_f32_wgmma.cu")
_Q_BWD_SRC = (f"{CSRC}layernorm_snap_rows.cu; {CSRC}gemm_f32x3_wgmma.cu; "
              f"{CSRC}attention_core_f32_bwd_wgmma.cu; "
              f"{CSRC}layernorm_rows_bwd.cu")
INT8_QAT_VARIANTS = {
    "fused_attention_block_i8": (_Q_SRC, f"{TPU_ATTN} (int8)", "K1 int8"),
    "fused_attention_block_i8[bwd]": (_Q_BWD_SRC, f"{TPU_ATTN_BWD} (int8)",
                                      "K2 int8"),
    "fused_mlp_block_i8": (f"{CSRC}layernorm_snap_rows.cu; "
                           f"{CSRC}gemm_f32x3_wgmma.cu",
                           f"{TPU_MLP} (int8)", "K3 int8"),
    "fused_mlp_block_i8[bwd]": (_Q_BWD_SRC.replace(
        f"{CSRC}attention_core_f32_bwd_wgmma.cu; ", ""),
        f"{TPU_MLP_BWD} (int8)", "K4 int8"),
}
FP32_KERNELS = tuple(k for k in KERNELS
                     if k not in INT8_KERNELS + DETECT_KERNELS + FLOAT_KERNELS
                     + QAT_KERNELS + LONG_FLOAT_KERNELS)
# flash_attention_fwd cases (B, H, N, D, n_valid, tag): YOLOS-S at 800 px
# (2601 tokens, n_pad 2688 > 1536: the blocked regime K6) and at 512 px
# (1125 tokens: the unblocked K5), and a ragged case with masked keys
FLASH_CASES = [(8, 6, 2601, 64, None, "K6 regime, 800 px"),
               (8, 6, 1125, 64, None, "K5 regime, 512 px"),
               (3, 2, 50, 32, 40, "ragged, n_valid 40")]
# fused attention chain lengths above one block of shared memory: YOLOS-S
# at 224 and 384 px, both under the fused gate (fuses_at: N <= 701)
LONG_CHAIN_N = (297, 677)
# flash_attention_bwd cases (B, H, N, D, n_valid, tag): YOLOS-S training
# at 400 px (726 tokens, n_pad 768: K8), 592 px (1470, n_pad 1536: K8's
# top), 608 px (1545, n_pad 1664: K7) and a 608 x 1008 crop (38 x 63
# patches: 2495 tokens, K7), and a ragged case with masked keys and rows
FLASH_BWD_CASES = [(2, 6, 726, 64, None, "K8 regime, 400 px"),
                   (2, 6, 1470, 64, None, "K8 top, 592 px"),
                   (2, 6, 1545, 64, None, "K7 regime, 608 px"),
                   (2, 6, 2495, 64, None, "K7, 608x1008 crop"),
                   (3, 2, 50, 32, 40, "ragged, n_valid 40")]
# the fused attention backward above 256 tokens: YOLOS-S training at 256
# and 384 px, both under the fused gate
LONG_BWD_N = (357, 677)
# the fused core's kernels, whose long route above 256 tokens the kernels
# line lists case by case
LONG_KERNELS = ("attention_core", "attention_core_bwd")
# the float formats' long core (phase 3): YOLOS-S's fused canvases from
# 257 tokens to the fused gate (357 at 256 px, 677 at 384 px, 701 the
# gate), at head widths 64 (6 heads) and 32 (12 heads, the same C), at the
# train step's micro-batch of 2 and at batch 8
LONG_FLOAT_N = (257, 357, 677, 701)
# the long fp32 core past its score-block design (768 tokens), (N, D,
# heads): yolos_tiny.json's fused canvases at 3 heads of 64 (769 just past
# it, 1001 at 480 px, 1017 at the fused gate) and the gate's longest at
# one head of 64 (1806) and of 32 (1837, the route's top); and where the
# cluster design is forced against the score-block design
SWEEP_CASES = ((769, 64, 3), (1001, 64, 3), (1017, 64, 3), (1806, 64, 1),
               (1837, 32, 1))
SWEEP_FORCED_N = (257, 677, 701, 768)
# YOLOS-S in FP16_32 (phase detect-float): the first QAT step's canvases
# (384 px: 677 tokens, the long kernels; 608 px: 1545 tokens, the discrete
# float Block), and the train CLI's scales (288-352 px: 425-585 tokens, all
# through the long kernels; DIOR's train scales run 256-608 px)
FLOAT_DET_CANVASES = ((384, "fused, long f32 core"),
                      (608, "discrete float Block"))
FLOAT_TRAIN_SCALES = [288, 320, 352]
# detection training (phase 8): images of the train split per epoch, and
# the canvases forced for the first-step check, one per backward regime
DET_TRAIN_SUBSET = 32
DET_CANVASES = ((384, "fused, long core backward"), (512, "discrete, K8"),
                (608, "discrete, K7"))
# Detection eval, kernel path against plain path (phase 7): in the
# discrete blocks the flash kernel is the only step that differs (it
# rounds e against each 128-key tile's running max where the plain K6
# order uses 384-key tiles, about 2^-9 of an attention output), and
# everything around it is the same PyTorch call on the same inputs, so a
# difference has to pass through 12 blocks' bf16 residual stream.
# pred_boxes (sigmoid outputs) are held to the chain bar per element.
# pred_logits were first held to it too and missed it at 1.39x (max abs
# 0.0234, on a logit near 0.08; argmax 100%; H100 80GB HBM3, 700 W): a
# logit is a 384-term product of the last residual stream, whose bf16
# steps are 2^-5 to 2^-4 after 12 blocks, so one flipped element there
# moves a small logit by more than 2^-6.  They take the bar phase 4 holds
# a 12-block model's logits to, 2^-4 of their largest magnitude, and at
# least 99% of the det tokens' argmax labels agreeing.
DET_ARGMAX_BAR = 0.99


def check(ok, message):
    """Fail the run (a raise, so that it survives python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {message}")


def require_cuda():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script runs on a CUDA device only")


def _ops():
    """(the differentiable ops, forward and backward counted: FP32, the
    float formats and INT8 QAT; the converted INT8 ops, forward only)."""
    from myrtle_vision_tpu_torch.ops.fused_attention_block import (
        fused_attention_block,
        fused_attention_block_i8,
    )
    from myrtle_vision_tpu_torch.ops.fused_int8_block import (
        int8_attention_block,
        int8_mlp_block,
    )
    from myrtle_vision_tpu_torch.ops.fused_mlp import (
        fused_mlp_block,
        fused_mlp_block_i8,
    )

    return ((fused_attention_block, fused_mlp_block, fused_attention_block_i8,
             fused_mlp_block_i8), (int8_attention_block, int8_mlp_block))


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


def block_inputs(b, n, seed, device, c=C, hid=HID):
    """bf16 activations and upstream gradient, fp32 parameters of one
    block of width ``c`` and MLP ``hid``, from a numpy seed.  Each weight
    is the (in, out) view of a torch (out, in) tensor, as the ViT block
    passes it, so the kernels read every weight in the main path's
    layout.  Biases and the upstream gradient are std 1, as large as what
    they are added to, so that each one shows in the output."""
    rng = np.random.RandomState(seed)
    x = seeded(rng, (b, n, c), 1.0, device, torch.bfloat16)
    attn = [seeded(rng, (c,), 0.1, device) + 1, seeded(rng, (c,), 0.1, device),
            seeded(rng, (3 * c, c), c ** -0.5, device).t(),
            seeded(rng, (3 * c,), 1.0, device),
            seeded(rng, (c, c), c ** -0.5, device).t(),
            seeded(rng, (c,), 1.0, device)]
    mlp = [seeded(rng, (c,), 0.1, device) + 1, seeded(rng, (c,), 0.1, device),
           seeded(rng, (hid, c), c ** -0.5, device).t(),
           seeded(rng, (hid,), 1.0, device),
           seeded(rng, (c, hid), hid ** -0.5, device).t(),
           seeded(rng, (c,), 1.0, device)]
    do = seeded(rng, (b, n, c), 1.0, device, torch.bfloat16)
    return x, attn, mlp, do


def bar(kind, ref):
    """(rtol, atol) of a bar kind for reference output ``ref``."""
    if kind == "kernel":
        return RTOL, KERNEL_ATOL
    if kind == "chain":
        return RTOL, CHAIN_ATOL
    if kind == "scaled chain":
        return RTOL, CHAIN_ATOL * ref.float().square().mean().sqrt().item()
    largest = ref.float().abs().max().item()
    if kind == "psum":
        return 0.0, PSUM_ATOL * largest
    return RTOL, SUM_ATOL * max(1.0, largest)


def bar_share(label, got, ref, rtol, atol):
    """Max abs difference, and the largest share of its element's bar
    rtol * |ref| + atol that any element takes."""
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{label}: {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}")
    g, r = got.float(), ref.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite output")
    diff = (g - r).abs()
    return diff.max().item(), (diff / (rtol * r.abs() + atol)).max().item()


def compare(label, got, ref, rtol, atol):
    """:func:`bar_share`, failing the run if an element exceeds its bar."""
    max_abs, of_bar = bar_share(label, got, ref, rtol, atol)
    check(of_bar <= 1.0, f"{label}: max abs {max_abs}, {of_bar:.3g} x its "
          f"element's bar {rtol:g} * |ref| + {atol:g}")
    return max_abs, of_bar


def as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def heads_of(qkv3, heads=HEADS):
    """q, k, v (B, H, N, D) of (B, N, 3C) rows, contiguous."""
    b, n, c3 = qkv3.shape
    t = qkv3.view(b, n, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4)
    return [u.contiguous() for u in t]


def kernel_cases(x, attn, mlp, do, heads=HEADS):
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
    b, n, c = x.shape
    rows = b * n
    scale = (c // heads) ** -0.5
    x2, do2 = x.view(rows, c), do.view(rows, c)
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
    qkv3 = qkv.view(b, n, 3 * c)
    ctx, m, rs = K.attention_core_plain(qkv3, heads, scale, stats=True)
    ctx = ctx.view(rows, c)
    # the same weights laid out the other way
    wqkv_o, wp_o = wqkv.contiguous(), wp.contiguous()
    # backward intermediates
    d_o = K.gemm_bf16_epilogue_plain(do2, wp.t(), None, "f32")
    dqkv, dbq_image = K.attention_core_bwd_plain(
        qkv3, d_o.view(b, n, c), m, rs, heads, scale)
    dqkv = dqkv.view(rows, 3 * c)
    dxn = K.gemm_bf16_epilogue_plain(dqkv, wqkv.t(), None, "f32")
    g_r, gp = K.gemm_bf16_epilogue_plain(xn, w1, b1, "bias_gelu_grad")
    dh, _ = K.gemm_bf16_epilogue_plain(do2, w2.t(), None, "mul_aux", aux=gp)
    gemm = (K.gemm_bf16_epilogue_cuda, K.gemm_bf16_epilogue_plain)

    def mm(name, args, kinds, count, **kw):
        a, w, bias, epilogue = args
        m, k, nn = a.shape[0], a.shape[1], w.shape[1]
        out = {"f32": 4, "bias_gelu_grad": 6}.get(epilogue, 2) * m * nn
        extra = nbytes(bias, kw.get("residual"), kw.get("aux"))
        cst = cost(nbytes(a, w) + out + extra, 2 * m * nn * k, "bf16",
                   lambda: torch.matmul(a, w))
        return (f"gemm_bf16_epilogue[{name}]",
                lambda: gemm[0](*args, **kw), lambda: gemm[1](*args, **kw),
                kinds, count, cst)

    q, k, v = heads_of(qkv3, heads)
    core_ops = 4 * b * heads * n * n * (c // heads)
    d_oh = heads_of(torch.cat([d_o.view(b, n, c)] * 3, -1).to(bf),
                    heads)[0]
    flash = []  # the forward's outputs, made at the first (warm-up) call

    def flash_bwd():
        if not flash:
            flash.extend(torch.ops.aten._scaled_dot_product_flash_attention(
                q, k, v, 0.0, False, False, scale=scale))
        out, lse, cq, ck, mq, mk, ps, po = flash[:8]
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            d_oh, q, k, v, out, lse, cq, ck, mq, mk, 0.0, False, ps, po,
            scale=scale)

    ln_mean, ln_rstd = torch.ops.aten.native_layer_norm(x2, [c], s, bi,
                                                        K.EPS)[1:]
    dxn_bf = dxn.to(bf)
    stats = 2 * b * heads * n * 4
    core_bwd_cost = cost(2 * nbytes(qkv3) + nbytes(d_o, m, rs, dbq_image),
                         core_ops * 5 // 2, "bf16", flash_bwd)
    return [
        ("layernorm_rows", lambda: K.layernorm_rows_cuda(x2, s, bi),
         lambda: K.layernorm_rows_plain(x2, s, bi), ("kernel",), 4,
         cost(2 * nbytes(x2) + nbytes(s, bi), 8 * x2.numel(), "fp32",
              lambda: F.layer_norm(x2, (c,), s, bi, K.EPS))),
        mm("qkv,bias", (xn, wqkv, bqkv, "bias"), ("kernel",), 1),
        mm("qkv,bias, other layout", (xn, wqkv_o, bqkv, "bias"),
           ("kernel",), 0),
        mm("proj,bias+residual", (ctx, wp, bp, "bias_residual"), ("kernel",),
           1, residual=x2),
        mm("fc1,bias+gelu", (xn, w1, b1, "bias_gelu"), ("kernel",), 1),
        mm("fc2,bias+residual", (g, w2, b2, "bias_residual"), ("kernel",), 1,
           residual=x2),
        ("attention_core", lambda: K.attention_core_cuda(qkv3, heads, scale),
         lambda: K.attention_core_plain(qkv3, heads, scale), ("kernel",), 0,
         cost(nbytes(qkv3) * 4 // 3, core_ops, "bf16",
              lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))),
        ("attention_core[stats]",
         lambda: K.attention_core_cuda(qkv3, heads, scale, stats=True),
         lambda: K.attention_core_plain(qkv3, heads, scale, stats=True),
         ("kernel", "kernel", "kernel"), 1,
         cost(nbytes(qkv3) * 4 // 3 + stats, core_ops, "bf16",
              lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))),
        # the long route (one kernel) forced at this N, timed beside
        ("attention_core[KV-tiled]",
         lambda: K.attention_core_cuda(qkv3, heads, scale, stats=True,
                                       tiled=True),
         lambda: K.attention_core_plain(qkv3, heads, scale, stats=True),
         ("kernel", "kernel", "kernel"), 0,
         cost(nbytes(qkv3) * 4 // 3 + stats, core_ops, "bf16",
              lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))),
        # backward
        mm("d_o=do.Wp^T,f32", (do2, wp.t(), None, "f32"), ("kernel",), 1),
        mm("d_o=do.Wp^T,f32, other layout", (do2, wp_o.t(), None, "f32"),
           ("kernel",), 0),
        ("attention_core_bwd",
         lambda: K.attention_core_bwd_cuda(qkv3, d_o.view(b, n, c), m, rs,
                                           heads, scale),
         lambda: K.attention_core_bwd_plain(qkv3, d_o.view(b, n, c), m, rs,
                                            heads, scale),
         ("chain", "psum"), 1, core_bwd_cost),
        # the long route (four kernels) forced at this N, timed beside
        ("attention_core_bwd[KV-tiled]",
         lambda: K.attention_core_bwd_cuda(qkv3, d_o.view(b, n, c), m, rs,
                                           heads, scale, tiled=True),
         lambda: K.attention_core_bwd_plain(qkv3, d_o.view(b, n, c), m, rs,
                                            heads, scale),
         ("chain", "psum"), 0, core_bwd_cost),
        ("colsum_rows[dbqkv]", lambda: K.colsum_rows_cuda(dbq_image),
         lambda: K.colsum_rows_plain(dbq_image), ("sum",), 1,
         cost(nbytes(dbq_image) + 4 * dbq_image.shape[1], dbq_image.numel(),
              "fp32", lambda: torch.sum(dbq_image, 0))),
        mm("dWp=do^T.ctx,A^T", (do2.t(), ctx, None, "f32"), ("sum",), 1),
        ("colsum_rows[dbp,db2]", lambda: K.colsum_rows_cuda(do2),
         lambda: K.colsum_rows_plain(do2), ("sum",), 2,
         cost(nbytes(do2) + 4 * c, do2.numel(), "fp32",
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
         cost(nbytes(x2, s, dxn, do2, x2) + 8 * c, 12 * x2.numel(), "fp32",
              lambda: torch.ops.aten.native_layer_norm_backward(
                  dxn_bf, x2, [c], ln_mean, ln_rstd, s, bi,
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
    from myrtle_vision_tpu_torch.quantize import QFormat, convert_params

    x, fp = calibrated_int8_block(b, n, seed, device)
    conv = Block(C, HEADS, C // HEADS, HID, 0.0, 12, device,
                 QFormat.PyTorchINT8, True)
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


def calibrated_int8_block(b, n, seed, device):
    """fp32 activations from a numpy seed and a ViT-S/16 PyTorchINT8 Block
    of seeded fp32 weights (Linear U(+-1/sqrt(fan_in)) and biases std 1,
    LayerNorm 1 + noise) calibrated by its own calibrating forward on
    them."""
    from myrtle_vision_tpu_torch.models.vit import Block
    from myrtle_vision_tpu_torch.quantize import QFormat, is_observer

    rng = np.random.RandomState(seed)
    x = seeded(rng, (b, n, C), 1.0, device)
    fp = Block(C, HEADS, C // HEADS, HID, 0.0, 12, device,
               QFormat.PyTorchINT8)
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
        fp.forward_int8(x)
    return x, fp


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


def op_cases(x, attn, mlp, do, heads=HEADS):
    """(name, kernel thunk, plain thunk, bar kinds) of each block-half
    chain, forward and backward (with the qkv rows saved and recomputed),
    ``heads`` heads of 64.
    Each path's backward starts from its own forward's residuals, as on
    the main path: rows recomputed by one GEMM have to meet the rowmax
    and rowsum that the same GEMM's rows gave in the forward."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops import fused_attention_block as fa
    from myrtle_vision_tpu_torch.ops import fused_mlp as fm

    scale = (x.shape[-1] // heads) ** -0.5

    res_kernel = fa._forward(K.CUDA, x, *attn, heads, scale, record=True)[1]
    res_plain = fa._forward(K.PLAIN, x, *attn, heads, scale, record=True)[1]
    attn_bwd = attn[:-1]  # the backward takes no bp
    grads = ("chain",) + ("sum",) * 6

    def attn_back(kern, saved):
        ctx, m, rs, qkv = res_kernel if kern is K.CUDA else res_plain
        return fa._backward(kern, do, x, *attn_bwd, ctx, m, rs,
                            qkv if saved else None, heads, scale)

    return [
        ("fused_attention_block",
         lambda: fa.fused_attention_block(x, *attn, heads, scale),
         lambda: fa.fused_attention_block_plain(x, *attn, heads, scale),
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


def float_step(v, qspec):
    """One step of the format (exp_bits, man_bits) at |v|: 2^(exponent -
    man_bits), the subnormal quantum below the smallest normal."""
    exp_bits, man_bits, _ = qspec
    min_exp = 2 - 2 ** (exp_bits - 1)
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** min_exp)))
    return torch.exp2(e - man_bits)


def compare_float(label, got, ref, qspec, first=None, chain=False,
                  hold_share=True):
    """(max abs difference, share of the float bar taken, share of the
    elements past the fp32 noise) of a float-format output; fails the run
    past the bar.  ``first``: the first of two values snapped in series
    (the GELU's input, the projection a residual sum adds), or None;
    ``hold_share``: False holds only the steps of the format."""
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{label}: {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    g, r = got.double(), ref.double()
    diff = (g - r).abs()
    largest = r.abs().max().item()
    tight = FLOAT_TIGHT * largest
    beyond = diff > tight
    share = beyond.double().mean().item()
    if chain:
        worst = diff.max().item() / (tight + float_step(
            torch.tensor(largest), qspec).item())
        same = FLOAT_CHAIN_SAME
    else:
        at, steps = r.abs(), 1
        if first is not None:
            at, steps = torch.maximum(at, first.double().abs()), 2
        worst = (diff[beyond] / (steps * float_step(at[beyond], qspec))
                 ).max().item() if bool(beyond.any()) else 0.0
        same = FLOAT_SAME
    of_bar = max(share / (1 - same), worst) if hold_share else worst
    check(of_bar <= 1.0, f"{label}: {share:.3g} of the elements past the fp32 "
          f"noise, max abs {diff.max().item()}, {worst:.3g} of a format step")
    return diff.max().item(), of_bar, share


def fake_quant_values(n, device):
    """n fp32 values for K11: magnitudes 2^-149 (fp32 subnormals) to 2^24
    (past fp16's range) of either sign, led by halfway ties of the fp16 /
    TF32 mantissas, the fp16 subnormal quantum and the fixed-point quanta,
    values at and past saturation, and signed zeros."""
    gen = torch.Generator(device).manual_seed(11)
    mag = torch.exp2(torch.rand(n, device=device, generator=gen) * 173 - 149)
    sign = torch.randint(0, 2, (n,), device=device, generator=gen) * 2 - 1
    x = mag * sign
    k = torch.arange(-2000, 2000, device=device, dtype=torch.float64) + 0.5
    special = torch.cat([
        k * 2.0 ** -10, k * 2.0 ** -24, k * 2.0 ** -9, k * 2.0 ** -8,
        k * 2.0 ** -7, 2.0 ** 12 * (1 + k.abs() * 2.0 ** -10),
        torch.tensor([0.0, -0.0, 65504.0, 65519.0, 65520.0, -65520.0, 1e38,
                      -1e38, 3.4e38, 2.0 ** -149, -2.0 ** -149, 2.0 ** -126,
                      2.0 ** -14, 2.0 ** -25, 4.0 - 2.0 ** -8, 4.0, -4.0,
                      8.0, 16.0], device=device, dtype=torch.float64)])
    x[:special.numel()] = special.float()
    return x, special.numel()


def float_block_inputs(b, n, seed, device, qspec):
    """fp32 activations and one ViT-S/16 block's float-format operands
    from a numpy seed: Linear weights U(+-1/sqrt(fan_in))-sized through the
    format's fake-quant, as the converted model holds them, each the (in,
    out) view of the torch (out, in) tensor as the Block passes it; biases
    std 1; LayerNorm 1 + noise."""
    from myrtle_vision_tpu_torch.ops.fake_quant import float_quantize

    rng = np.random.RandomState(seed)
    x = seeded(rng, (b, n, C), 1.0, device)

    def weight(out_f, in_f):
        w = seeded(rng, (out_f, in_f), in_f ** -0.5, device)
        return float_quantize(w, qspec[0], qspec[1]).t()

    attn = [seeded(rng, (C,), 0.1, device) + 1, seeded(rng, (C,), 0.1, device),
            weight(3 * C, C), seeded(rng, (3 * C,), 1.0, device),
            weight(C, C), seeded(rng, (C,), 1.0, device)]
    mlp = [seeded(rng, (C,), 0.1, device) + 1, seeded(rng, (C,), 0.1, device),
           weight(HID, C), seeded(rng, (HID,), 1.0, device),
           weight(C, HID), seeded(rng, (C,), 1.0, device)]
    return x, attn, mlp


def float_kernel_cases(x, attn, mlp, qspec):
    """(name, kernel thunk, plain thunk, a thunk of the first of two values
    its epilogue snaps in series (given its output) or None, launches per
    converted block in a forward, cost) for each float-format
    chain kernel at the main path's shapes and layouts, inputs prepared
    with the plain versions as the ops chain them.  Yardsticks:
    ``F.layer_norm``, three bf16 ``torch.matmul`` of the pre-split
    operands (the tensor-core work of the 3-pass product) and
    ``F.scaled_dot_product_attention`` in fp32."""
    import torch.nn.functional as F

    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.high_precision import split_bf16

    b, n, _ = x.shape
    x2 = x.view(-1, C)
    s_a, b_a, wqkv, bqkv, wp, bp = attn
    s_m, b_m, w1, b1, w2, b2 = mlp
    check(wqkv.t().is_contiguous() and w1.t().is_contiguous(),
          "weights not in the main path's layout")
    xn = K.layernorm_snap_rows_plain(x2, s_a, b_a, qspec)
    qkv3 = K.gemm_f32x3_epilogue_plain(xn, wqkv, bqkv, "bias_snap",
                                       qspec).view(b, n, 3 * C)
    ctx = K.attention_core_snap_plain(qkv3, HEADS, SCALE, qspec).view(-1, C)
    xm = K.layernorm_snap_rows_plain(x2, s_m, b_m, qspec)
    g = K.gemm_f32x3_epilogue_plain(xm, w1, b1, "bias_snap_gelu_snap", qspec)
    q, k, v = heads_of(qkv3)

    def mm(name, a, w, bias, epilogue, residual=None):
        m, kk, nn = a.shape[0], a.shape[1], w.shape[1]
        first = None
        if residual is not None:
            def first(out):
                return out - residual
        elif epilogue == "bias_snap_gelu_snap":
            def first(_):
                return K.gemm_f32x3_epilogue_plain(a, w, bias, "bias_snap",
                                                   qspec)
        ah, al = (t.to(torch.bfloat16) for t in split_bf16(a))
        wh, wl = (t.to(torch.bfloat16) for t in split_bf16(w))
        c = cost(nbytes(a, w, bias, residual) + 4 * m * nn,
                 3 * 2 * m * nn * kk, "bf16",
                 lambda: (torch.matmul(ah, wh), torch.matmul(ah, wl),
                          torch.matmul(al, wh)))
        args = (a, w, bias, epilogue, qspec)
        return (f"gemm_f32x3_epilogue[{name}]",
                lambda: K.gemm_f32x3_epilogue_cuda(*args, residual=residual),
                lambda: K.gemm_f32x3_epilogue_plain(*args, residual=residual),
                first, 1, c)

    return [
        ("layernorm_snap_rows",
         lambda: K.layernorm_snap_rows_cuda(x2, s_a, b_a, qspec),
         lambda: K.layernorm_snap_rows_plain(x2, s_a, b_a, qspec), None, 2,
         cost(2 * nbytes(x2) + nbytes(s_a, b_a), 14 * x2.numel(), "fp32",
              lambda: F.layer_norm(x2, (C,), s_a, b_a, K.EPS))),
        mm("qkv,bias+snap", xn, wqkv, bqkv, "bias_snap"),
        # the attention core's float mode; its launches count under the
        # converted INT8 forward's kernel line, so 0 here
        ("attention_core_f32[snap]",
         lambda: K.attention_core_snap_cuda(qkv3, HEADS, SCALE, qspec),
         lambda: K.attention_core_snap_plain(qkv3, HEADS, SCALE, qspec),
         None, 0,
         cost(nbytes(qkv3) * 4 // 3, 3 * 4 * b * HEADS * n * n * (C // HEADS),
              "bf16",
              lambda: F.scaled_dot_product_attention(q, k, v, scale=SCALE))),
        mm("proj,bias+snap+residual+snap", ctx, wp, bp,
           "bias_snap_residual_snap", residual=x2),
        mm("fc1,bias+snap+gelu+snap", xm, w1, b1, "bias_snap_gelu_snap"),
        mm("fc2,bias+snap+residual+snap", g, w2, b2, "bias_snap_residual_snap",
           residual=x2),
    ]


def fake_quant_block_cases(attn, mlp, qspec):
    """K11 at a converted block's sites in one forward (the JAX Block's
    ``_qw``): each Linear weight's fake-quant, (out, in) as stored, and the
    two LayerNorm scales'; the yardstick for e5m10 the fp16 cast."""
    from myrtle_vision_tpu_torch.ops import _kernels as K

    e, m = qspec[:2]
    out = []
    for name, w, count in (("wqkv", attn[2].t(), 1), ("wp", attn[4].t(), 1),
                           ("w1", mlp[2].t(), 1), ("w2", mlp[4].t(), 1),
                           ("norm scale", attn[0], 2)):
        out.append((
            f"fake_quant_rows[{name}]",
            lambda w=w: K.fake_quant_rows_cuda(w, "float", e, m),
            lambda w=w: K.fake_quant_rows_plain(w, "float", e, m), None,
            count, cost(2 * nbytes(w), 10 * w.numel(), "fp32",
                        (lambda w=w: w.clamp(-65504, 65504).half().float())
                        if (e, m) == (5, 10) else None)))
    return out


def float_op_cases(x, attn, mlp, qspec):
    """(name, kernel thunk, plain thunk) of both float-format block-half
    chains."""
    from myrtle_vision_tpu_torch.ops import fused_attention_block as fa
    from myrtle_vision_tpu_torch.ops import fused_mlp as fm

    return [
        ("fused_attention_block[qspec]",
         lambda: fa.fused_attention_block(x, *attn, HEADS, SCALE,
                                          qspec=qspec),
         lambda: fa.fused_attention_block_plain(x, *attn, HEADS, SCALE,
                                                qspec=qspec)),
        ("fused_mlp_block[qspec]",
         lambda: fm.fused_mlp_block(x, *mlp, qspec=qspec),
         lambda: fm.fused_mlp_block_plain(x, *mlp, qspec=qspec)),
    ]


def phase_kernels_float(device):
    """K11 in its five modes, bit for bit; each float-format chain kernel
    and both chains with each qspec.  Returns the largest abs errors at
    B=64 by kernel."""
    from myrtle_vision_tpu_torch.ops import _kernels as K

    errors = {"fake_quant_rows": 0.0}
    x, n_special = fake_quant_values(FAKE_QUANT_N, device)
    sub = int(((x.abs() < 2.0 ** -126) & (x != 0)).sum())
    unaligned = x[1:1000004]  # 4 bytes past a 16-byte boundary: scalar path
    for mode, a, b in FAKE_QUANT_MODES:
        got = K.fake_quant_rows_cuda(x, mode, a, b)
        ref = K.fake_quant_rows_plain(x, mode, a, b)
        got_u = K.fake_quant_rows_cuda(unaligned, mode, a, b)
        ref_u = K.fake_quant_rows_plain(unaligned, mode, a, b)
        torch.cuda.synchronize()
        same = (torch.equal(got.view(torch.int32), ref.view(torch.int32))
                and torch.equal(got_u.view(torch.int32),
                                ref_u.view(torch.int32)))
        line = (f"kernels: fake_quant_rows[{mode} {a},{b}] on {x.numel()} "
                f"values ({sub} fp32 subnormals, {n_special} ties and edge "
                f"values) and an unaligned view of {unaligned.numel()}: "
                f"bit-identical to the plain version {same}")
        if (mode, a, b) == ("float", 5, 10):
            half = x.clamp(-65504, 65504).half().float()
            same_half = torch.equal(got.view(torch.int32),
                                    half.view(torch.int32))
            line += f", to x.clamp(-65504, 65504).half().float() {same_half}"
            same = same and same_half
        print(line)
        check(same, f"fake_quant_rows {mode} {a},{b} is not bit-identical")
    del x, unaligned, got, ref, got_u, ref_u
    for qname, qspec in FLOAT_QSPECS.items():
        for b, n, tag in ((64, N, "B=64,N=197"), (3, 50, "B=3,N=50")):
            x, attn, mlp = float_block_inputs(b, n, seed=b * 1000 + n + 2,
                                              device=device, qspec=qspec)
            cases = [(name, kern, plain, first, False) for name, kern, plain,
                     first, _, _ in float_kernel_cases(x, attn, mlp, qspec)]
            cases += [(name, kern, plain, None, True)
                      for name, kern, plain in float_op_cases(x, attn, mlp,
                                                              qspec)]
            for name, kernel, plain, first, chain in cases:
                ref = plain()
                max_abs, of_bar, share = compare_float(
                    f"{name} {qname} {tag}", kernel(), ref, qspec,
                    None if first is None else first(ref), chain)
                kind = "chain" if chain else "kernel"
                print(f"kernels: {name} {qname} {tag} max_abs {max_abs:.6g}, "
                      f"{of_bar:.4f} of the bar ({share:.5f} of the elements "
                      f"past the fp32 noise; {kind})")
                key = name.split("[")[0]
                if b == 64:
                    errors[key] = max(errors.get(key, 0.0), max_abs)
        c11_repeats(device, qname, qspec)
    return errors


# ROADMAP C11: each call of the float formats' K1 op and of its kernels
# chained by hand at B=64, N=197, bit for bit the first call's
C11_CALLS = 250


def c11_repeats(device, qname, qspec):
    """The K1 op (``qspec``) and its four kernels chained by hand
    (``layernorm_snap_rows``, the qkv ``gemm_f32x3_epilogue``,
    ``attention_core_snap``, the projection's), C11_CALLS calls each on
    the kernels phase's B=64 inputs, every output compared bitwise with
    the first call's.  Before the repair one chained call in ~70 gave a
    wrong row of one projection tile."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops import fused_attention_block as fa
    from myrtle_vision_tpu_torch.ops.fake_quant import kernel_sites

    x, attn, _ = float_block_inputs(64, N, seed=64 * 1000 + N + 2,
                                    device=device, qspec=qspec)
    s_ln, b_ln, wqkv, bqkv, wp, bp = attn
    b, n, c = x.shape
    x2 = x.view(b * n, c)

    def chain():
        xn = K.layernorm_snap_rows_cuda(x2, s_ln, b_ln,
                                        kernel_sites(qspec, 0))
        qkv = K.gemm_f32x3_epilogue_cuda(xn, wqkv, bqkv, "bias_snap",
                                         kernel_sites(qspec, 1))
        ctx = K.attention_core_snap_cuda(qkv.view(b, n, 3 * c), HEADS, SCALE,
                                         kernel_sites(qspec, 2))
        return K.gemm_f32x3_epilogue_cuda(
            ctx.view(b * n, c), wp, bp, "bias_snap_residual_snap",
            kernel_sites(qspec, 3, 4), residual=x2)

    for name, fn in (("the op", lambda: fa.fused_attention_block(
            x, *attn, HEADS, SCALE, qspec=qspec)), ("its kernels", chain)):
        t0 = time.perf_counter()
        first = fn()
        differ = sum(not torch.equal(fn(), first) for _ in range(C11_CALLS))
        print(f"kernels: C11 repeats: fused_attention_block[qspec] {qname} "
              f"B=64,N={N}, {name}: {differ} of {C11_CALLS} calls differ "
              f"bitwise from the first ({time.perf_counter() - t0:.1f} s)")
        check(differ == 0, f"C11: {qname} {name}: {differ} calls differ")


def qat_kernel_cases(x, attn, mlp, do, qspec):
    """(name, kernel thunk, plain thunk, bar kinds, launches per block in
    a QAT train step's backward, cost, a thunk of the first of two values
    snapped in series or None) for each kernel of the float-format
    backward chains (K2 and K4 with qspec) at the main path's shapes and
    layouts, inputs prepared with the plain versions as the chains
    prepare them: the data-gradient products read the torch (out, in)
    weight row-major as it is stored, the weight-gradient products the
    (K, M) activation as it is stored.  Bar kinds as the FP32 ones
    ("kernel", "chain", "sum", "psum": the outputs are unsnapped fp32
    gradients), and "float" for the snapped GELU output of the fc1
    recompute (the float bar, its input snapped before it).  Yardsticks:
    three bf16 ``torch.matmul`` of each product's pre-split operands, the
    backward of fp32 ``F.scaled_dot_product_attention`` for the core,
    ``F.layer_norm``'s autograd backward, ``torch.sum``."""
    import torch.nn.functional as F

    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.high_precision import split_bf16

    b, n, _ = x.shape
    rows = b * n
    x2, do2 = x.view(rows, C), do.view(rows, C)
    s_a, b_a, wqkv, bqkv, wp, _ = attn
    s_m, b_m, w1, b1, w2, _ = mlp
    check(wp.t().is_contiguous() and w2.t().is_contiguous(),
          "weights not in the main path's layout")
    xn = K.layernorm_snap_rows_plain(x2, s_a, b_a, qspec)
    qkv3 = K.gemm_f32x3_epilogue_plain(xn, wqkv, bqkv, "bias_snap",
                                       qspec).view(b, n, 3 * C)
    ctx, m, rs = K.attention_core_snap_plain(qkv3, HEADS, SCALE, qspec,
                                             stats=True)
    ctx2 = ctx.view(rows, C)
    d_o = K.gemm_f32x3_epilogue_plain(do2, wp.t(), None, "f32", qspec)
    d_o3 = d_o.view(b, n, C)
    dqkv, dbq_image = K.attention_core_f32_bwd_plain(qkv3, d_o3, m, rs,
                                                     HEADS, SCALE)
    dqkv2 = dqkv.view(rows, 3 * C)
    dxn = K.gemm_f32x3_epilogue_plain(dqkv2, wqkv.t(), None, "f32", qspec)
    xm = K.layernorm_snap_rows_plain(x2, s_m, b_m, qspec)
    g, gp = K.gemm_f32x3_epilogue_plain(xm, w1, b1,
                                        "bias_snap_gelu_snap_grad", qspec)
    dh, _ = K.gemm_f32x3_epilogue_plain(do2, w2.t(), None, "mul_aux", qspec,
                                        aux=gp)
    q, k, v = heads_of(qkv3)
    d_oh = heads_of(torch.cat([d_o3] * 3, -1))[0]
    sdpa = []  # the forward's graph, made at the first (warm-up) call

    def sdpa_bwd():
        if not sdpa:
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            sdpa.append((F.scaled_dot_product_attention(
                *leaves, scale=SCALE), leaves))
        out, leaves = sdpa[0]
        return torch.autograd.grad(out, leaves, d_oh, retain_graph=True)

    ln = []

    def ln_bwd():
        if not ln:
            leaves = [t.detach().requires_grad_() for t in (x2, s_a, b_a)]
            ln.append((F.layer_norm(leaves[0], (C,), *leaves[1:], K.EPS),
                       leaves))
        out, leaves = ln[0]
        return torch.autograd.grad(out, leaves, dxn, retain_graph=True)

    def mm(name, a, w, epilogue, kinds, count, bias=None, aux=None,
           first=None):
        m_, kk, nn = a.shape[0], a.shape[1], w.shape[1]
        ah, al = (t.to(torch.bfloat16) for t in split_bf16(a))
        wh, wl = (t.to(torch.bfloat16) for t in split_bf16(w))
        out = (8 if epilogue == "bias_snap_gelu_snap_grad" else 4) * m_ * nn
        c = cost(nbytes(a, w, bias, aux) + out, 3 * 2 * m_ * nn * kk, "bf16",
                 lambda: (torch.matmul(ah, wh), torch.matmul(ah, wl),
                          torch.matmul(al, wh)))
        args = (a, w, bias, epilogue, qspec)
        return (f"gemm_f32x3_epilogue[{name}]",
                lambda: K.gemm_f32x3_epilogue_cuda(*args, aux=aux),
                lambda: K.gemm_f32x3_epilogue_plain(*args, aux=aux),
                kinds, count, c, first)

    core = 4 * b * HEADS * n * n * (C // HEADS)  # one N x N x D product
    return [
        ("attention_core_f32[snap,stats]",
         lambda: K.attention_core_snap_cuda(qkv3, HEADS, SCALE, qspec,
                                            stats=True),
         lambda: K.attention_core_snap_plain(qkv3, HEADS, SCALE, qspec,
                                             stats=True),
         ("float", "kernel", "kernel"), 0,
         cost(nbytes(qkv3) * 4 // 3 + nbytes(m, rs), 3 * core, "bf16",
              lambda: F.scaled_dot_product_attention(q, k, v, scale=SCALE)),
         None),
        mm("d_o=do.Wp^T,f32", do2, wp.t(), "f32", ("kernel",), 1),
        ("attention_core_f32_bwd",
         lambda: K.attention_core_f32_bwd_cuda(qkv3, d_o3, m, rs, HEADS,
                                               SCALE),
         lambda: K.attention_core_f32_bwd_plain(qkv3, d_o3, m, rs, HEADS,
                                                SCALE),
         ("chain", "psum"), 1,
         # s (recomputed), dp, dv, dq, dk: five products, three passes
         cost(2 * nbytes(qkv3) + nbytes(d_o3, m, rs, dbq_image),
              3 * core * 5 // 2, "bf16", sdpa_bwd), None),
        ("colsum_rows[dbqkv,fp32]", lambda: K.colsum_rows_cuda(dbq_image),
         lambda: K.colsum_rows_plain(dbq_image), ("sum",), 1,
         cost(nbytes(dbq_image) + 4 * dbq_image.shape[1], dbq_image.numel(),
              "fp32", lambda: torch.sum(dbq_image, 0)), None),
        mm("dWp=do^T.ctx,A^T", do2.t(), ctx2, "f32", ("sum",), 1),
        ("colsum_rows[dbp,db2,fp32]", lambda: K.colsum_rows_cuda(do2),
         lambda: K.colsum_rows_plain(do2), ("sum",), 2,
         cost(nbytes(do2) + 4 * C, do2.numel(), "fp32",
              lambda: torch.sum(do2, 0)), None),
        mm("dWqkv=dqkv^T.xn,A^T", dqkv2.t(), xn, "f32", ("sum",), 1),
        mm("dxn=dqkv.Wqkv^T,f32", dqkv2, wqkv.t(), "f32", ("kernel",), 1),
        ("layernorm_snap_rows_bwd",
         lambda: K.layernorm_rows_bwd_cuda(x2, s_a, dxn, do2, qspec),
         lambda: K.layernorm_rows_bwd_plain(x2, s_a, dxn, do2, qspec),
         ("kernel", "sum", "sum"), 2,
         cost(nbytes(x2, s_a, dxn, do2, x2) + 8 * C, 16 * x2.numel(),
              "fp32", ln_bwd), None),
        mm("fc1 remat,bias+snap+gelu+snap+gelu'", xm, w1,
           "bias_snap_gelu_snap_grad", ("float", "kernel"), 1, bias=b1,
           first=lambda: K.gemm_f32x3_epilogue_plain(xm, w1, b1, "bias_snap",
                                                     qspec)),
        mm("dW2=do^T.g,A^T", do2.t(), g, "f32", ("sum",), 1),
        mm("dh=do.W2^T*gelu',colsum", do2, w2.t(), "mul_aux",
           ("kernel", "sum"), 1, aux=gp),
        mm("dW1=dh^T.xn,A^T", dh.t(), xm, "f32", ("sum",), 1),
        mm("dxn=dh.W1^T,f32", dh, w1.t(), "f32", ("kernel",), 1),
    ]


def qat_op_cases(x, attn, mlp, do, qspec):
    """(name, kernel thunk, plain thunk, bar kinds) of both float-format
    backward chains, the attention's with its qkv rows saved and
    recomputed, each path from its own forward's residuals."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops import fused_attention_block as fa
    from myrtle_vision_tpu_torch.ops import fused_mlp as fm

    res = [fa._forward_q(kern, x, *attn, HEADS, SCALE, qspec,
                         record=True)[1] for kern in (K.CUDA, K.PLAIN)]
    grads = ("chain",) + ("sum",) * 6

    def attn_back(kern, saved):
        ctx, m, rs, qkv = res[kern is K.PLAIN]
        return fa._backward_q(kern, do, x, *attn[:-1], ctx, m, rs,
                              qkv if saved else None, HEADS, SCALE, qspec)

    return [
        ("fused_attention_block[qspec,bwd,saved qkv]",
         lambda: attn_back(K.CUDA, True), lambda: attn_back(K.PLAIN, True),
         grads),
        ("fused_attention_block[qspec,bwd,recomputed qkv]",
         lambda: attn_back(K.CUDA, False), lambda: attn_back(K.PLAIN, False),
         grads),
        ("fused_mlp_block[qspec,bwd]",
         lambda: fm._backward_q(K.CUDA, do, x, *mlp[:-1], qspec),
         lambda: fm._backward_q(K.PLAIN, do, x, *mlp[:-1], qspec), grads),
    ]


def phase_kernels_qat(device):
    """The float-format backward kernels and chains, each against its
    plain version, in each format at B=64, N=197; returns the largest abs
    errors by kernel."""
    errors = {}
    for qname, qspec in FLOAT_QSPECS.items():
        x, attn, mlp = float_block_inputs(64, N, seed=64197 + 3, device=device,
                                          qspec=qspec)
        do = seeded(np.random.RandomState(64197 + 4), (64, N, C), 1.0, device)
        cases = [(name, kern, plain, kinds, first) for name, kern, plain,
                 kinds, _, _, first in qat_kernel_cases(x, attn, mlp, do,
                                                        qspec)]
        cases += [c + (None,) for c in qat_op_cases(x, attn, mlp, do, qspec)]
        for name, kernel, plain, kinds, first in cases:
            outs, refs = as_tuple(kernel()), as_tuple(plain())
            check(len(outs) == len(refs) == len(kinds),
                  f"{name}: {len(outs)} outputs")
            worst = (0.0, 0.0)
            for i, (got, ref, kind) in enumerate(zip(outs, refs, kinds)):
                label = f"{name} {qname} output {i}"
                if kind == "float":
                    max_abs, of_bar, _ = compare_float(
                        label, got, ref, qspec,
                        None if first is None else first())
                else:
                    max_abs, of_bar = compare(label, got, ref,
                                              *bar(kind, ref))
                worst = max(worst, (of_bar, max_abs))
            print(f"kernels: {name} {qname} B=64,N=197 max_abs "
                  f"{worst[1]:.6g}, {worst[0]:.4f} of the bar (kinds "
                  f"{'/'.join(kinds)})")
            key = name.split("[")[0]
            errors[key] = max(errors.get(key, 0.0), worst[1])
    return errors


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
    errors["flash_attention_fwd"], errors["flash_attention_bwd"] = \
        phase_kernels_long(device)
    for key, err in phase_kernels_float(device).items():
        errors[key] = max(errors.get(key, 0.0), err)
    for key in QAT_KERNELS:
        errors[key] = 0.0
    for key, err in phase_kernels_qat(device).items():
        if key in QAT_KERNELS:
            errors[key] = max(errors[key], err)
    errors.update(phase_kernels_long_float(device))
    print(f"kernels: all within their bars (|d| <= {RTOL:g}*|ref| + atol; "
          f"atol {KERNEL_ATOL:g} kernel, {CHAIN_ATOL:g} chain, "
          f"{SUM_ATOL:g}*max|ref| sum; psum |d| <= {PSUM_ATOL:g}*max|ref|; "
          f"INT8: >= {INT8_SAME} identical and <= {INT8_STEPS} grid steps, "
          f"a chain {INT8_CHAIN_SAME} and {INT8_CHAIN_STEPS}; float formats: "
          f">= {FLOAT_SAME} within {FLOAT_TIGHT:g}*max|ref| and the rest "
          f"within 1-2 format steps, a chain {FLOAT_CHAIN_SAME} and one step "
          f"at max|ref|; K11 bit-identical)")
    return errors


def counted(name, n_launch, fn):
    """``fn()``, checking that it launched ``n_launch`` of kernel ``name``
    and nothing else."""
    from myrtle_vision_tpu_torch.ops import _kernels as K

    before = dict(K.LAUNCHES)
    out = fn()
    grew = {k: K.LAUNCHES[k] - v for k, v in before.items()
            if K.LAUNCHES[k] != v}
    check(grew == {name: n_launch}, f"{name}: launches {grew}")
    return out


def long_float_case(n, d, heads, b, device, errors):
    """The float formats' long core at B=b, N=n, ``heads`` heads of d:
    the forward in each format, with and without the statistics, the
    context under the float bar and the rowmax and reciprocal rowsum under
    the one-kernel bar; the backward from the plain forward's statistics,
    dqkv under the chain bar and the per-image column sums under the psum
    bar; each call's launches counted; the largest max abs differences
    into ``errors``."""
    from myrtle_vision_tpu_torch.ops import _kernels as K

    c, sc = heads * d, d ** -0.5
    rng = np.random.RandomState(n * 1000 + d * 10 + b)
    qkv = seeded(rng, (b, n, 3 * c), 1.0, device)
    d_o = seeded(rng, (b, n, c), 1.0, device)
    plan = K.f32_long_plan(n, d, b, heads)
    design = (f"cluster design, {plan['fwd']['cluster']} CTAs a cluster"
              if plan["sweep"] else "score-block")
    tag = f"B={b} N={n} D={d} H={heads}"
    fwd = (0.0, 0.0, 0.0)
    for qname, qspec in FLOAT_QSPECS.items():
        for stats in (False, True):
            got = as_tuple(counted(
                "attention_core_f32_long", K.F32_LONG_FWD_LAUNCHES,
                lambda: K.attention_core_snap_cuda(qkv, heads, sc, qspec,
                                                   stats=stats)))
            ref = as_tuple(K.attention_core_snap_plain(qkv, heads, sc, qspec,
                                                       stats=stats))
            label = (f"attention_core_f32_long {qname}"
                     f"{'+stats' if stats else ''} {tag}")
            max_abs, of_bar, share = compare_float(f"{label} context",
                                                   got[0], ref[0], qspec)
            for i in range(1, len(got)):
                m_abs, m_bar = compare(f"{label} output {i}", got[i], ref[i],
                                       RTOL, KERNEL_ATOL)
                max_abs, of_bar = max(max_abs, m_abs), max(of_bar, m_bar)
            fwd = max(fwd, (of_bar, max_abs, share))
    errors["attention_core_f32_long"] = max(
        errors["attention_core_f32_long"], fwd[1])
    _, m, rs = K.attention_context_f32(qkv, heads, sc, stats=True)
    got = counted("attention_core_f32_bwd_long", K.F32_LONG_BWD_LAUNCHES,
                  lambda: K.attention_core_f32_bwd_cuda(qkv, d_o, m, rs,
                                                        heads, sc))
    ref = K.attention_core_f32_bwd_plain(qkv, d_o, m, rs, heads, sc)
    bwd = (0.0, 0.0)
    for i, (g, r, kind) in enumerate(zip(got, ref, ("chain", "psum"))):
        max_abs, of_bar = compare(
            f"attention_core_f32_bwd_long {tag} output {i}", g, r,
            *bar(kind, r))
        bwd = max(bwd, (of_bar, max_abs))
    errors["attention_core_f32_bwd_long"] = max(
        errors["attention_core_f32_bwd_long"], bwd[1])
    if n > K.F32_LONG_BLOCK_MAX_N:
        for (name, _, _), err in zip(SWEEP_KERNELS, (fwd[1], bwd[1])):
            errors[name] = max(errors.get(name, 0.0), err)
    print(f"kernels: attention_core_f32_long {tag} ({design}; FP16_16, "
          f"FP16_32, TF32; with and without statistics) max_abs "
          f"{fwd[1]:.6g}, {fwd[0]:.4f} of the bar, at most {fwd[2]:.5f} of a "
          f"context past the fp32 noise; attention_core_f32_bwd_long max_abs "
          f"{bwd[1]:.6g}, {bwd[0]:.4f} of the bar (kinds chain/psum)")


def sweep_vs_block(device):
    """The forward's cluster design forced at :data:`SWEEP_FORCED_N`
    (B=2, 6 heads of 64 and 12 of 32), where the score-block design runs,
    in every mode (a float format's snap with the statistics, INT8 QAT's
    site snap with the statistics, the converted model's int8 grid): both
    designs against the plain version at their bars, the share of
    elements where the two designs differ, and whether the cluster
    design's row max (its scores the plain version's in-order sums) is the
    plain version's bit for bit."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    qspec = FLOAT_QSPECS["FP16_32"]
    lines = []
    for n in SWEEP_FORCED_N:
        for d in (64, 32):
            heads, sc = C // d, d ** -0.5
            qkv = seeded(np.random.RandomState(5 * n + d), (2, n, 3 * C),
                         1.0, device)
            site = long_int8_site(qkv, heads, sc)
            refs = {
                "FP16_32+stats": as_tuple(K.attention_core_snap_plain(
                    qkv, heads, sc, qspec, stats=True)),
                "int8 sites+stats": as_tuple(K.attention_core_snap_plain(
                    qkv, heads, sc, Int8Sites(site), stats=True)),
                "int8 out": as_tuple(K.attention_core_f32_plain(
                    qkv, heads, sc, site))}
            outs = {}
            for sweep in (False, True):
                for mode, run in (
                        ("FP16_32+stats", lambda: K.attention_core_snap_cuda(
                            qkv, heads, sc, qspec, stats=True, sweep=sweep)),
                        ("int8 sites+stats", lambda: K.attention_core_snap_cuda(
                            qkv, heads, sc, Int8Sites(site), stats=True,
                            sweep=sweep)),
                        ("int8 out", lambda: K.attention_core_f32_cuda(
                            qkv, heads, sc, site, sweep=sweep))):
                    got = as_tuple(counted("attention_core_f32_long",
                                           K.F32_LONG_FWD_LAUNCHES, run))
                    ref = refs[mode]
                    label = (f"attention_core_f32_long "
                             f"{'cluster' if sweep else 'score-block'} "
                             f"{mode} N={n} D={d}")
                    if mode == "FP16_32+stats":
                        compare_float(f"{label} context", got[0], ref[0],
                                      qspec)
                    elif mode == "int8 sites+stats":
                        compare_sites(f"{label} context", got[0], ref[0],
                                      site_step(site))
                    else:
                        compare_grid(label, got[0], ref[0], 1.0)
                    for i in range(1, len(got)):
                        compare(f"{label} output {i}", got[i], ref[i], RTOL,
                                KERNEL_ATOL)
                    outs[(sweep, mode)] = got
            differ = [(outs[(False, m)][0] != outs[(True, m)][0]).float()
                      .mean().item() for m in refs]
            same_max = torch.equal(outs[(True, "FP16_32+stats")][1],
                                   refs["FP16_32+stats"][1])
            lines.append(f"N={n} D={d}: {', '.join(f'{x:.5f}' for x in differ)}"
                         f", row max {'=' if same_max else '!='} plain")
            del qkv
    print(f"kernels: attention_core_f32_long's cluster design forced at "
          f"B=2 where the score-block design runs, both within their bars of "
          f"the plain version in every mode; the share of elements where "
          f"the designs differ (FP16_32 context, INT8 site context, int8 "
          f"grid) and the cluster row max against the plain version's: "
          f"{'; '.join(lines)}")


def phase_kernels_long_float(device):
    """The float formats' long core against its plain version
    (:func:`long_float_case`) at :data:`LONG_FLOAT_N` x head widths 64 and
    32 (6 and 12 heads) x batches 2 and 8, and past the score-block design
    at :data:`SWEEP_CASES` x batches 2 and 8 (the forward's cluster
    design); each call's launches counted (2 and 4, none of the one-CTA
    kernels').  Then the cluster design forced where the score-block
    design runs (:func:`sweep_vs_block`), and, forced at
    197 tokens (``tiled``; ViT-S/16, B=64), the long route against the
    one-CTA kernels.  Inputs: fp32 qkv rows and d_o drawn at std 1.
    Returns the largest max abs differences by kernel."""
    from myrtle_vision_tpu_torch.ops import _kernels as K

    errors = dict.fromkeys(LONG_FLOAT_KERNELS, 0.0)
    for n in LONG_FLOAT_N:
        for d in (64, 32):
            for b in (2, 8):
                long_float_case(n, d, C // d, b, device, errors)
    for n, d, heads in SWEEP_CASES:
        for b in (2, 8):
            long_float_case(n, d, heads, b, device, errors)
    sweep_vs_block(device)

    # forced at 197 tokens, against the one-CTA kernels
    qspec = FLOAT_QSPECS["FP16_32"]
    rng = np.random.RandomState(64197 + 5)
    qkv = seeded(rng, (64, N, 3 * C), 1.0, device)
    d_o = seeded(rng, (64, N, C), 1.0, device)
    long = counted("attention_core_f32_long",
                            K.F32_LONG_FWD_LAUNCHES,
                   lambda: K.attention_core_snap_cuda(
                       qkv, HEADS, SCALE, qspec, stats=True, tiled=True))
    short = K.attention_core_snap_cuda(qkv, HEADS, SCALE, qspec, stats=True)
    worst = [compare_float("forced long core context", long[0], short[0],
                           qspec)[:2]]
    worst += [compare(f"forced long core output {i}", long[i], short[i],
                      RTOL, KERNEL_ATOL) for i in (1, 2)]
    got = counted("attention_core_f32_bwd_long", K.F32_LONG_BWD_LAUNCHES,
                  lambda: K.attention_core_f32_bwd_cuda(
                      qkv, d_o, short[1], short[2], HEADS, SCALE,
                      tiled=True))
    want = K.attention_core_f32_bwd_cuda(qkv, d_o, short[1], short[2], HEADS,
                                         SCALE)
    worst_b = [compare(f"forced long backward output {i}", g, r,
                       *bar(kind, r))
               for i, (g, r, kind) in enumerate(zip(got, want,
                                                    ("chain", "psum")))]
    print(f"kernels: the long f32 core forced at B=64,N=197 (FP16_32) "
          f"against the one-CTA kernels: forward max_abs "
          f"{max(w[0] for w in worst):.6g}, {max(w[1] for w in worst):.4f} "
          f"of the bar; backward max_abs {max(w[0] for w in worst_b):.6g}, "
          f"{max(w[1] for w in worst_b):.4f} of the bar")
    return errors


# the probes' check shapes (B, N) at ViT-S/16 widths, and the widths of
# classification/train_configs/vit_{tiny,base}.json (dim, heads, MLP) at
# which the FP32 block chains K1-K4 and the K12 / K13 probes are held
PROBE_SHAPES = ((64, N, "B=64,N=197"), (3, 50, "B=3,N=50"))
# the probe tools' default batch, at which they and the variants' plain
# versions and yardsticks are timed; the attribution tools' batch, that
# of PERF.md's main-path metrics
PROBE_BATCH = 512
ATTRIBUTION_BATCH = 256
PROBE_WIDTHS = ((192, 3, 768, "dim 192, 3 heads, MLP 768 (vit_tiny.json)"),
                (768, 12, 3072, "dim 768, 12 heads, MLP 3072 (vit_base.json)"))
# The K12 variant "none" divides by the rowsum of e = 0.01 s, a sum of
# signed scores that can come near 0, where its fp32 noise (2^-24 of the
# sum of |e|) is no longer small against the sum: the divided output has
# no fixed relative bar.  The phase holds the parts apart instead: the
# undivided product bf16(bf16(e) v) to the kernel bar and the rowsum to
# the sum bar; the divided chain's share of the chain bar is printed.
# The K12 variant "dotonly" normalizes nothing (no LayerNorm, no scale,
# no softmax): its unscaled scores (~8), context and output (~100) are
# ~100x the other chains' activations, and so is what one flipped bf16
# rounding moves, so its chain bar's atol is CHAIN_ATOL times the output's
# RMS ("scaled chain").  The K14 products sum exact products of bf16
# values in fp32, kernel and plain version alike: bar 2^-16 of the largest
# output (FLOAT_TIGHT).
# the probes in the kernels line: (source, the TPU kernel, the headline
# variant, its tool).  The probe modes and instantiations keep the WMMA
# designs that the wgmma kernels replaced; K12's `base` and K13's `prod`
# run the production chains, and so time the wgmma kernels.
PROBES = {
    "K12": (f"{CSRC}attention_core.cu (probe modes); "
            f"{CSRC}gemm_bf16_epilogue.cu (probe instantiations)",
            "tools/perf/attn_microbench.py:275", "defer"),
    "K13": (f"{CSRC}gemm_bf16_epilogue.cu (GELU modes)",
            "tools/perf/mlp_microbench.py:119", "base"),
    "K14": (f"{CSRC}gemm_layout_probe.cu",
            "tools/perf/layout_probe.py:81", "dw  xn^T@dqkv implicit (0,0)"),
}
# the launch counter of each probe's kernel
PROBE_COUNTERS = {"K12": "attention_core_probe",
                  "K13": "gemm_bf16_gelu_probe", "K14": "gemm_layout_probe"}


def probe_check(label, kernel, plain, kind):
    """Hold one probe output against its plain version; returns its max
    abs difference."""
    if kind == "fp32":
        ref = plain.float()
        max_abs, of_bar = compare(label, kernel, plain, 0.0,
                                  FLOAT_TIGHT * ref.abs().max().item())
    else:
        max_abs, of_bar = compare(label, kernel, plain, *bar(kind, plain))
    print(f"probes: {label} max_abs {max_abs:.6g}, {of_bar:.4f} of the bar "
          f"({kind})")
    return max_abs


def check_probes(b, n, c, heads, tag, device, seed):
    """Every K12 and K13 variant (the kernels' chains) against its plain
    chain; K12 ``none`` through its parts.  Returns {probe: max abs}."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.perf import attn_microbench as am
    from myrtle_vision_tpu_torch.perf import mlp_microbench as mm

    inputs = am.make_inputs(b, n, c, heads, seed, device)
    k12, p12 = am.variants(inputs, heads), am.variants(inputs, heads, True)
    mlp_in = mm.make_inputs(b, n, c, seed + 1, device)
    k13, p13 = mm.variants(mlp_in), mm.variants(mlp_in, True)
    errors = {"K12": 0.0, "K13": 0.0}
    for name in am.VARIANTS:
        if name in am.YARDSTICKS:
            continue
        out, ref = k12[name](), p12[name]()
        if name == "none":
            max_abs, of_bar = bar_share(f"K12 none {tag}", out, ref,
                                        *bar("chain", ref))
            print(f"probes: K12 none {tag} max_abs {max_abs:.6g}, "
                  f"{of_bar:.4f} of the chain bar (printed, not held: the "
                  "parts below are)")
            x2 = inputs["x"].view(b * n, c)
            w, bq = am.variant_weights(inputs["wqkv"], inputs["bqkv"],
                                       inputs["wp"], inputs["bp"],
                                       heads)["none"][:2]
            qkv = K.gemm_bf16_epilogue_plain(
                K.layernorm_rows_plain(x2, inputs["ln_s"], inputs["ln_b"]),
                w, bq, "bias").view(b, n, 3 * c)
            scale = (c // heads) ** -0.5
            parts = K.attention_core_probe_cuda(qkv, heads, scale, "none",
                                                parts=True)
            plain = K.attention_core_probe_plain(qkv, heads, scale, "none",
                                                 parts=True)
            for part, got, want, kind in zip(("u", "rowmax", "rowsum"),
                                             parts, plain,
                                             ("kernel", "kernel", "sum")):
                errors["K12"] = max(errors["K12"], probe_check(
                    f"K12 none[{part}] {tag}", got, want, kind))
            continue
        errors["K12"] = max(errors["K12"], probe_check(
            f"K12 {name} {tag}", out, ref,
            "scaled chain" if name == "dotonly" else "chain"))
    for name in mm.VARIANTS:
        errors["K13"] = max(errors["K13"], probe_check(
            f"K13 {name} {tag}", mm.joined(k13[name]()),
            mm.joined(p13[name]()), "chain"))
    return errors


def check_layout(b, n, tag, device):
    """Every K14 case against its plain version; returns the max abs."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.perf import layout_probe as lp

    err = 0.0
    for i, (name, shapes, contract, per_head, explicit) in enumerate(
            lp.cases(n, C, HEADS)):
        a, bb = lp.make_operands(shapes, b, 40 + i, device)
        heads = HEADS if per_head else None
        err = max(err, probe_check(
            f"K14 {name.strip()} {tag}",
            lp.case_fn(K.CUDA, a, bb, contract, heads, explicit)(),
            lp.case_fn(K.PLAIN, a, bb, contract, heads, explicit)(), "fp32"))
    return err


def check_widths(device):
    """The FP32 block chains K1-K4, forward and backward through the
    port's ops, and every K12 / K13 variant, at the tiny and base widths,
    B=16, N=197."""
    for c, heads, hid, tag in PROBE_WIDTHS:
        x, attn, mlp, do = block_inputs(16, N, seed=c, device=device, c=c,
                                        hid=hid)
        for name, kernel, plain, kinds in op_cases(x, attn, mlp, do, heads):
            outs, refs = as_tuple(kernel()), as_tuple(plain())
            check(len(outs) == len(refs) == len(kinds),
                  f"{name}: {len(outs)} outputs")
            worst = (0.0, 0.0)
            for i, (got, ref, kind) in enumerate(zip(outs, refs, kinds)):
                max_abs, of_bar = compare(f"{name} {tag} output {i}", got,
                                          ref, *bar(kind, ref))
                worst = max(worst, (of_bar, max_abs))
            print(f"probes: {name} B=16,N=197 {tag} max_abs {worst[1]:.6g}, "
                  f"{worst[0]:.4f} of the bar (kinds {'/'.join(kinds)})")
        del x, attn, mlp, do
        check_probes(16, N, c, heads, f"B=16,N=197 {tag}", device, seed=c)


def run_tool(module, argv):
    """Run a probe tool's ``main`` on the card with ``argv``, each line it
    prints repeated as a ``probes:`` line; returns its results."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = module.main(["--device", "cuda", *argv])
    name = module.__name__.rsplit(".", 1)[-1]
    for line in out.getvalue().splitlines():
        if line.strip():
            print(f"probes: {name}: {line}")
    return results


def phase_probes(device, power):
    """The probes K12-K14 and the attribution tools (myrtle_vision_tpu_
    torch/perf/): each probe kernel against its plain version, the K1-K4
    chains and the probes at the tiny and base widths, then the probe
    tools themselves at their default shapes (B=512) with every count
    reset just before and read just after, each variant's plain version,
    bound and yardstick, and both attribution tools at B=256.  Returns
    the kernels-line entries of K12-K14."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.perf import attn_microbench as am
    from myrtle_vision_tpu_torch.perf import int8_component_bench as icb
    from myrtle_vision_tpu_torch.perf import layout_probe as lp
    from myrtle_vision_tpu_torch.perf import mlp_microbench as mm
    from myrtle_vision_tpu_torch.perf import train_gap_bench as tgb

    t0 = time.perf_counter()
    errors = {"K12": 0.0, "K13": 0.0, "K14": 0.0}
    for b, n, tag in PROBE_SHAPES:
        for key, err in check_probes(b, n, C, HEADS, tag, device,
                                     seed=b * 1000 + n + 7).items():
            if b == 64:
                errors[key] = max(errors[key], err)
        err = check_layout(b, n, tag, device)
        if b == 64:
            errors["K14"] = max(errors["K14"], err)
    check_widths(device)
    print(f"probes: every K12 / K13 variant, K14 case and width within its "
          f"bar ({time.perf_counter() - t0:.1f} s)")

    # the probe tools at their default shapes: the slice's main path
    reset_counts()
    argv = ["--batch", str(PROBE_BATCH), "--iters", "10"]
    tool_ms = {"K12": run_tool(am, argv), "K13": run_tool(mm, argv),
               "K14": run_tool(lp, argv)}
    launches = read_counts()[0]
    for probe, counter in PROBE_COUNTERS.items():
        check(launches[counter] > 0,
              f"{probe}: {counter} never launched by its tool")
    print("probes: launches in the tools' runs: "
          + ", ".join(f"{k} {launches[c]} ({c})"
                      for k, c in PROBE_COUNTERS.items()))

    # plain versions, bounds and yardsticks at the same shapes (B=512)
    timed = {}
    inputs = am.make_inputs(PROBE_BATCH, N, C, HEADS, 0, device)
    p12 = am.variants(inputs, HEADS, True)
    mlp_in = mm.make_inputs(PROBE_BATCH, N, C, 0, device)
    p13 = mm.variants(mlp_in, True)
    rows = [("K12", name, p12[name], am.variant_cost(name, inputs, HEADS),
             name in ("base", "pvrow", "rowmajor", "defer", "pipe", "sumdot",
                      "mlp"))
            for name in am.VARIANTS if name not in am.YARDSTICKS]
    rows += [("K13", name, p13[name], mm.variant_cost(mlp_in),
              name not in ("nogelu", "noexp")) for name in mm.VARIANTS]
    for probe, name, plain, c_, same_function in rows:
        k_ms = tool_ms[probe][name]["ms"]
        p_ms = cuda_ms(plain, iters=2, warmup=1)
        lib_ms = cuda_ms(c_["library"]) if same_function else None
        b_ms, by = bound(c_)
        timed[(probe, name)] = (k_ms, p_ms, b_ms, by, lib_ms)
    del inputs, p12, mlp_in, p13
    for i, (name, shapes, contract, per_head, explicit) in enumerate(
            lp.cases(N, C, HEADS)):
        a, bb = lp.make_operands(shapes, PROBE_BATCH, i, device)
        heads = HEADS if per_head else None
        out_shape = lp.case_fn(K.CUDA, a, bb, contract, heads, explicit)(
            ).shape
        c_ = lp.case_cost(a, bb, contract, heads, out_shape)
        p_ms = cuda_ms(lp.case_fn(K.PLAIN, a, bb, contract, heads,
                                  explicit), iters=2, warmup=1)
        b_ms, by = bound(c_)
        timed[("K14", name)] = (tool_ms["K14"][name]["ms"], p_ms, b_ms, by,
                                cuda_ms(c_["library"]))
        del a, bb
    for (probe, name), (k_ms, p_ms, b_ms, by, lib_ms) in timed.items():
        lib = "none (another function)" if lib_ms is None \
            else f"{lib_ms:.4f} ms"
        print(f"timing: {probe} {name.strip()} B={PROBE_BATCH} N={N} kernel "
              f"{k_ms:.4f} ms plain {p_ms:.4f} ms, library {lib}, bound "
              f"{b_ms:.4f} ms ({by}) [{power}]")

    # attribution at the main-path batch
    run_tool(tgb, ["--batch", str(ATTRIBUTION_BATCH), "--iters", "5"])
    run_tool(icb, ["--batch", str(ATTRIBUTION_BATCH), "--iters", "5"])
    print(f"probes: phase done in {time.perf_counter() - t0:.1f} s")
    entries = []
    for probe, (source, replaces, headline) in PROBES.items():
        k_ms, p_ms, b_ms, by, lib_ms = timed[(probe, headline)]
        entries.append({
            "name": probe, "route": "cuda", "source": source,
            "replaces": replaces,
            # launches in the probe tools' run at their default shapes;
            # the largest error of any variant against its plain version
            # at B=64; the headline variant's times at B=512
            "launches": launches[PROBE_COUNTERS[probe]],
            "max_abs_err": errors[probe],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms,
        })
    return entries


def probe_device_ms(device):
    """{probe: the profiler's device ms of its headline variant} at the
    probe tools' shapes (B=512), the kernel path."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.perf import attn_microbench as am
    from myrtle_vision_tpu_torch.perf import layout_probe as lp
    from myrtle_vision_tpu_torch.perf import mlp_microbench as mm

    out = {}
    inputs = am.make_inputs(PROBE_BATCH, N, C, HEADS, 0, device)
    out["K12"] = kernel_device_ms(
        am.variants(inputs, HEADS)[PROBES["K12"][2]])[0]
    del inputs
    mlp_in = mm.make_inputs(PROBE_BATCH, N, C, 0, device)
    out["K13"] = kernel_device_ms(mm.variants(mlp_in)[PROBES["K13"][2]])[0]
    del mlp_in
    for i, (name, shapes, contract, per_head, explicit) in enumerate(
            lp.cases(N, C, HEADS)):
        if name == PROBES["K14"][2]:
            a, bb = lp.make_operands(shapes, PROBE_BATCH, i, device)
            out["K14"] = kernel_device_ms(lp.case_fn(
                K.CUDA, a, bb, contract, HEADS if per_head else None,
                explicit))[0]
    return out


def flash_inputs(b, h, n, d, seed, device, count=3):
    """bf16 (B, H, N, D) q, k, v (and with count 4 an output gradient),
    std 1, from a numpy seed."""
    rng = np.random.RandomState(seed)
    return [seeded(rng, (b, h, n, d), 1.0, device, torch.bfloat16)
            for _ in range(count)]


def phase_kernels_long(device):
    """The flash-attention forward, output and LSE, against its plain
    version (in the same regime) under the one-kernel bar at
    :data:`FLASH_CASES`; the fused attention chain and its KV-tiled core
    at :data:`LONG_CHAIN_N`; the flash backward and the long attention
    backward (:func:`phase_kernels_long_bwd`).  Returns the flash forward's
    and backward's largest max abs differences."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops import fused_attention_block as fa
    from myrtle_vision_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
    )

    worst_flash = 0.0
    for b, h, n, d, n_valid, tag in FLASH_CASES:
        q, k, v = flash_inputs(b, h, n, d, seed=n, device=device)
        got = K.flash_attention_fwd_cuda(q, k, v, d ** -0.5, n_valid,
                                         lse=True)
        ref = flash_attention_plain(q, k, v, d ** -0.5, n_valid, lse=True)
        worst = (0.0, 0.0)
        for i, (g, r) in enumerate(zip(got, ref)):
            max_abs, of_bar = compare(f"flash_attention_fwd {tag} output {i}",
                                      g, r, RTOL, KERNEL_ATOL)
            worst = max(worst, (of_bar, max_abs))
        worst_flash = max(worst_flash, worst[1])
        print(f"kernels: flash_attention_fwd B={b} H={h} N={n} D={d} "
              f"n_valid={n_valid or n} ({tag}) max_abs {worst[1]:.6g}, "
              f"{worst[0]:.4f} of the bar (kinds kernel/kernel: output, LSE)")
        del q, k, v, got, ref
    for n in LONG_CHAIN_N:
        x, attn, _, _ = block_inputs(16, n, seed=16000 + n, device=device)
        qkv = K.gemm_bf16_epilogue_plain(
            K.layernorm_rows_plain(x.view(-1, C), attn[0].to(torch.bfloat16),
                                   attn[1].to(torch.bfloat16)),
            attn[2].to(torch.bfloat16), attn[3], "bias").view(16, n, 3 * C)
        cases = [
            ("attention_core[stats]", ("kernel",) * 3,
             lambda: K.attention_core_cuda(qkv, HEADS, SCALE, stats=True),
             lambda: K.attention_core_plain(qkv, HEADS, SCALE, stats=True)),
            ("fused_attention_block", ("chain",),
             lambda: fa.fused_attention_block(x, *attn, HEADS, SCALE),
             lambda: fa.fused_attention_block_plain(x, *attn, HEADS, SCALE)),
        ]
        for name, kinds, kernel, plain in cases:
            worst = (0.0, 0.0)
            for i, (got, ref, kind) in enumerate(zip(
                    as_tuple(kernel()), as_tuple(plain()), kinds)):
                max_abs, of_bar = compare(f"{name} B=16,N={n} output {i}",
                                          got, ref, *bar(kind, ref))
                worst = max(worst, (of_bar, max_abs))
            print(f"kernels: {name} B=16,N={n} (KV-tiled core) max_abs "
                  f"{worst[1]:.6g}, {worst[0]:.4f} of the bar (kinds "
                  f"{'/'.join(kinds)})")
    return worst_flash, phase_kernels_long_bwd(device)


def phase_kernels_long_bwd(device):
    """The flash backward at :data:`FLASH_BWD_CASES`, the kernel from the
    kernel forward's output and LSE, the plain version (in the same
    regime) from the plain forward's: dq under the chain bar, dk and dv
    (sums over the queries) under the sum bar.  The attention core's
    backward (KV-tiled) and the fused attention backward chain at
    :data:`LONG_BWD_N`, B=4: the core on the plain forward's statistics
    for both, the chain from each path's own forward.  Returns the flash
    backward's largest max abs difference."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops import fused_attention_block as fa
    from myrtle_vision_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain,
        flash_attention_plain,
    )

    worst_bwd = 0.0
    for b, h, n, d, n_valid, tag in FLASH_BWD_CASES:
        q, k, v, do = flash_inputs(b, h, n, d, seed=n + 2, device=device,
                                   count=4)
        sc = d ** -0.5
        o, lse = K.flash_attention_fwd_cuda(q, k, v, sc, n_valid, lse=True)
        got = K.flash_attention_bwd_cuda(q, k, v, o, do, lse, sc, n_valid)
        o_p, lse_p = flash_attention_plain(q, k, v, sc, n_valid, lse=True)
        ref = flash_attention_bwd_plain(q, k, v, o_p, do, lse_p, sc, n_valid)
        worst = (0.0, 0.0)
        for g, r, kind, name in zip(got, ref, ("chain", "sum", "sum"),
                                    ("dq", "dk", "dv")):
            max_abs, of_bar = compare(f"flash_attention_bwd {tag} {name}",
                                      g, r, *bar(kind, r))
            worst = max(worst, (of_bar, max_abs))
        if n_valid is not None:
            check(not any(g[:, :, n_valid:].any() for g in got),
                  "flash_attention_bwd: gradients past n_valid")
        worst_bwd = max(worst_bwd, worst[1])
        print(f"kernels: flash_attention_bwd B={b} H={h} N={n} D={d} "
              f"n_valid={n_valid or n} ({tag}) max_abs {worst[1]:.6g}, "
              f"{worst[0]:.4f} of the bar (kinds chain/sum/sum: dq, dk, dv)")
        del q, k, v, do, o, lse, got, o_p, lse_p, ref
    grads = ("chain",) + ("sum",) * 6
    for n in LONG_BWD_N:
        x, attn, _, do = block_inputs(4, n, seed=4000 + n, device=device)
        res_kernel = fa._forward(K.CUDA, x, *attn, HEADS, SCALE,
                                 record=True)[1]
        res_plain = fa._forward(K.PLAIN, x, *attn, HEADS, SCALE,
                                record=True)[1]
        _, m, rs, qkv = res_plain
        d_o = K.gemm_bf16_epilogue_plain(
            do.view(-1, C), attn[4].to(torch.bfloat16).t(), None,
            "f32").view(4, n, C)

        def attn_back(kern):
            ctx_, m_, rs_, qkv_ = res_kernel if kern is K.CUDA else res_plain
            return fa._backward(kern, do, x, *attn[:-1], ctx_, m_, rs_, qkv_,
                                HEADS, SCALE)

        cases = [
            ("attention_core_bwd", ("chain", "psum"),
             lambda: K.attention_core_bwd_cuda(qkv, d_o, m, rs, HEADS, SCALE),
             lambda: K.attention_core_bwd_plain(qkv, d_o, m, rs, HEADS,
                                                SCALE)),
            ("fused_attention_block[bwd,saved qkv]", grads,
             lambda: attn_back(K.CUDA), lambda: attn_back(K.PLAIN)),
        ]
        for name, kinds, kernel, plain in cases:
            worst = (0.0, 0.0)
            for i, (got, ref, kind) in enumerate(zip(
                    as_tuple(kernel()), as_tuple(plain()), kinds)):
                max_abs, of_bar = compare(f"{name} B=4,N={n} output {i}",
                                          got, ref, *bar(kind, ref))
                worst = max(worst, (of_bar, max_abs))
            print(f"kernels: {name} B=4,N={n} (KV-tiled backward) max_abs "
                  f"{worst[1]:.6g}, {worst[0]:.4f} of the bar (kinds "
                  f"{'/'.join(kinds)})")
        del x, attn, do, res_kernel, res_plain, d_o
    return worst_bwd


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
    expect = dict.fromkeys(launches, 0)  # every counter, probes too
    expect.update(layernorm_rows=2 * depth * batches,
                  gemm_bf16_epilogue=4 * depth * batches,
                  attention_core=depth * batches)
    check(launches == expect, f"kernel launches {launches}")
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


def two_pass(model, images, plain=False):
    """The two-pass INT8 QAT forward of training/classification.py: the
    calibrating pass (no gradient), then the differentiable pass with the
    observers it left, through the kernels or, with ``plain``, the plain
    chains."""
    with torch.no_grad():
        model(images, calibrating=True)
    return model(images, plain=plain, int8_fused=True)


def first_step_check(model, train_loader, init_ckpt, n_accum, micro,
                     first_loss, tag="train", criterion=None, teacher=None):
    """The train CLI's first step again, from its iteration-0 checkpoint
    (loaded before each path, observers and all) and its first batch
    (``model`` and ``train_loader`` as the CLI's ``build_train`` sets them
    up), on the kernel path and on the plain path; a PyTorchINT8 model
    takes the two-pass step; ``tag`` leads the printed line;
    ``criterion`` (logits, labels) -> loss is the CLI's loss, by default
    the classifier's cross entropy; with ``teacher`` the model is a
    DistillWrapper and the loss its distillation loss against the
    teacher's logits (a PyTorchINT8 student's one-pass step: its
    calibrating forward, differentiated)."""
    from myrtle_vision_tpu_torch.training.optim import cross_entropy_loss
    from myrtle_vision_tpu_torch.utils.convert import (
        load_reference_checkpoint,
    )

    criterion = criterion or cross_entropy_loss

    epoch = train_loader.epoch(0)
    batch = next(epoch)
    epoch.close()
    int8 = teacher is None and model.int8 and not model.converted
    init = (load_reference_checkpoint(init_ckpt) if teacher is None
            else torch.load(init_ckpt, weights_only=True)["model"])
    runs = {}
    for plain in (False, True):
        model.load_state_dict(init, strict=True)
        model.zero_grad(set_to_none=True)
        loss_sum = 0.0
        for i in range(n_accum):
            sl = slice(i * micro, (i + 1) * micro)
            images = batch["image"][sl]
            labels = batch["label"][sl]
            if teacher is not None:
                loss = model(images, labels.long(), teacher(images),
                             plain=plain, calibrating=model.student.int8)[0]
            else:
                logits = (two_pass(model, images, plain) if int8
                          else model(images, plain=plain))
                loss = criterion(logits, labels)
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
    print(f"{tag}: first step, kernel vs plain path on the card: loss "
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


@contextlib.contextmanager
def counting_plain_calls():
    """Counts, in the yielded dict, every call of a plain version through
    ``K.PLAIN`` (the block-half chains' plain path) while it is open."""
    from myrtle_vision_tpu_torch.ops import _kernels as K

    calls = {"n": 0}
    saved = dict(vars(K.PLAIN))

    def counted(fn):
        def run(*args, **kwargs):
            calls["n"] += 1
            return fn(*args, **kwargs)
        return run

    for name, fn in saved.items():
        setattr(K.PLAIN, name, counted(fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(K.PLAIN, name, fn)


def phase_qat(device, data_config, data_cfg):
    """The ViT-S/16 train CLI in FP16_32 (QAT) through the float-format
    kernels, forward and backward; returns the kernel launches of its
    run."""
    from myrtle_vision_tpu_torch.classification import test as eval_cli
    from myrtle_vision_tpu_torch.classification import train as train_cli

    q_format = "FP16_32"
    config = vit_small_config()
    config["vit_config"]["q_format"] = q_format
    tc = config["train_config"]
    tc.update(output_directory=os.path.join(WORK, "qat"),
              checkpoint_path="", epochs=1, warmup_epochs=0,
              pretrained_backbone=None, iters_per_checkpoint=3,
              iters_per_val=3)
    config["data_config_path"] = data_cfg
    cfg = write_json("vit_small_qat.json", config)
    depth = config["vit_config"]["depth"]

    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with counting_plain_calls() as plain_calls, \
            contextlib.redirect_stdout(out):
        state = train_cli.main(["-c", cfg, "--device", "cuda"])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("Iteration", "Epoch", "WARNING")):
            print(f"qat: {line}")
    steps = state.iteration
    losses = [float(v) for v in
              re.findall(r"Iteration \d+:\tloss=(\S+)\tacc=", text)]
    with contextlib.redirect_stdout(io.StringIO()):
        model, train_loader, val_loader, (micro, n_accum) = \
            train_cli.build_train(config, device)
    val_batches = len(val_loader)
    validations = len(range(0, steps, tc["iters_per_val"]))
    bwd = depth * n_accum * steps
    fwd = bwd + depth * validations * val_batches
    print(f"qat: ViT-S/16 train CLI in {q_format} on cuda, {steps} steps of "
          f"{n_accum} x {micro} images and {validations} validations of "
          f"{val_batches} batch in {took:.1f} s: op launches (forward, "
          f"backward) {ops}, expected ({fwd}, {bwd}) each ({depth} a "
          f"micro-batch); plain-version calls {plain_calls['n']}; kernels "
          f"{launches}")
    check(steps >= 3 and len(losses) == steps, f"{steps} steps, {losses}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    for op in ("fused_attention_block", "fused_mlp_block"):
        check(ops[op] == (fwd, bwd), f"{op} launches {ops[op]}")
    check(plain_calls["n"] == 0, "the QAT run called a plain version")
    check(all(launches[k] > 0 for k in FLOAT_KERNELS + QAT_KERNELS
              + ("attention_core_f32", "colsum_rows")),
          f"a kernel never launched: {launches}")
    check(launches["attention_core_f32_bwd"] == bwd
          and launches["layernorm_snap_rows_bwd"] == 2 * bwd,
          f"backward kernel launches {launches}")

    run_dir = sorted(glob.glob(tc["output_directory"] + "_*"))[-1]
    ckpts = sorted(os.listdir(run_dir))
    check(ckpts == [f"vit_{i:06}" for i in range(0, steps, 3)]
          + [f"vit_{steps:06}"], f"checkpoints {ckpts}")
    first_step_check(model, train_loader, os.path.join(run_dir, "vit_000000"),
                     n_accum, micro, losses[0], tag="qat")
    del model, train_loader, val_loader

    tc["checkpoint_path"] = os.path.join(run_dir, ckpts[-1])
    cfg = write_json("vit_small_qat_eval.json", config)
    with open(os.path.join(data_config["dataset_path"],
                           data_config["test_files"])) as f:
        test_batches = len(f.read().split()) // micro  # drop_last_batch
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        gts, preds, logits = eval_cli.main(["-c", cfg, "--device", "cuda"])
    _, ops_eval = read_counts()
    print(f"qat: checkpoint {ckpts[-1]} through the eval CLI ({q_format}): "
          f"{len(gts)} test images, accuracy "
          f"{float(np.mean(gts == preds)):.4f}, op launches {ops_eval}")
    check(logits.shape[1] == data_config["number_of_classes"]
          and bool(torch.isfinite(logits).all()), "eval of the checkpoint")
    check(ops_eval["fused_attention_block"] == (depth * test_batches, 0),
          f"eval launches {ops_eval}")
    return launches


def qat_int8_block_inputs(b, n, seed, device, fresh=False):
    """fp32 activations and one ViT-S/16 block's INT8 QAT operands: the
    Block of :func:`calibrated_int8_block`, each Linear weight through
    its symmetric int8 fake-quant as the Block's second pass passes it
    (the (in, out) view of the (out, in) result), and its (2, 5, 3) site
    table, calibrated on these activations; ``fresh``: row 2 of each half
    without statistics, as an observer that has seen nothing."""
    from myrtle_vision_tpu_torch.quantize import QFormat, quantize_weight

    x, fp = calibrated_int8_block(b, n, seed, device)
    with torch.no_grad():
        sites = fp.site_table()
        if fresh:
            sites[:, 2] = torch.tensor([1.1920929e-7, 0.0, 0.0],
                                       device=device)
    qkv, out, fc1, fc2 = fp._linears()
    a, f = fp._modules["0"].fn.norm, fp._modules["1"].fn.norm

    def qw(lin):
        return quantize_weight(lin.weight.detach(), QFormat.PyTorchINT8,
                               "linear", False).t()

    attn = [a.weight.detach(), a.bias.detach(), qw(qkv), qkv.bias.detach(),
            qw(out), out.bias.detach()]
    mlp = [f.weight.detach(), f.bias.detach(), qw(fc1), fc1.bias.detach(),
           qw(fc2), fc2.bias.detach()]
    return x, attn, mlp, sites


def site_step(site):
    """The grid step of a site row: its scale, 0 without statistics."""
    return float(site[0]) if float(site[2]) > 0.5 else 0.0


def series_bar(s1, s2):
    """(step, steps) of an output snapped at a site of step ``s2`` after
    one of step ``s1`` in series (either 0 where it has no statistics):
    the first's flip, through a slope under 1.2, reaches the second grid
    as up to ceil(1.2 s1 / s2) + 1 of its steps."""
    if s2 == 0.0:
        return 1.2 * s1, 1
    return s2, 1 + math.ceil(1.2 * s1 / s2)


def compare_sites(label, got, ref, step, steps=1, same=I8_SAME):
    """(max abs difference, share of the INT8 QAT bar taken, share of the
    elements past the fp32 noise) of an output on a site's grid of step
    ``step`` (0: unsnapped, the noise alone); fails the run past the
    bar."""
    torch.cuda.synchronize()
    check(got.shape == ref.shape and got.dtype == ref.dtype,
          f"{label}: {got.shape} {got.dtype} vs {ref.shape} {ref.dtype}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    diff = (got.double() - ref.double()).abs()
    tight = FLOAT_TIGHT * ref.abs().max().item()
    share = (diff > tight).double().mean().item()
    worst = diff.max().item() / (tight + steps * step * (1 + 1e-5))
    of_bar = max(share / (1 - same), worst)
    check(of_bar <= 1.0, f"{label}: {share:.3g} of the elements past the "
          f"fp32 noise, max abs {diff.max().item()} ({worst:.3g} of "
          f"{steps} steps of {step:g})")
    return diff.max().item(), of_bar, share


def qat_int8_kernel_cases(x, attn, mlp, do, sites):
    """(name, kernel thunk, plain thunk, bars) of each kernel in its INT8
    mode on the two-pass QAT path at the main path's shapes and layouts,
    inputs prepared with the plain versions as the chains prepare them:
    the forward chains' LayerNorm, QKV, attention core (with its
    statistics), projection, fc1 and fc2, and the backward's fc1
    recompute and LayerNorm backward.  ``bars``: per output, (step,
    steps) of its site grid, or an FP32 bar kind for an unsnapped
    gradient."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    b, n, _ = x.shape
    rows = b * n
    x2, do2 = x.view(rows, C), do.view(rows, C)
    sa, sm = sites[0], sites[1]
    step = [[site_step(r) for r in t] for t in (sa, sm)]
    s_a, b_a, wqkv, bqkv, wp, bp = attn
    s_m, b_m, w1, b1, w2, _ = mlp
    check(wqkv.t().is_contiguous() and w1.t().is_contiguous(),
          "weights not in the main path's layout")
    xn = K.layernorm_snap_rows_plain(x2, s_a, b_a, Int8Sites(sa[0]))
    qkv3 = K.gemm_f32x3_epilogue_plain(xn, wqkv, bqkv, "bias_snap",
                                       Int8Sites(sa[1])).view(b, n, 3 * C)
    ctx = K.attention_core_snap_plain(qkv3, HEADS, SCALE, Int8Sites(sa[2]))
    xm = K.layernorm_snap_rows_plain(x2, s_m, b_m, Int8Sites(sm[0]))
    g = K.gemm_f32x3_epilogue_plain(xm, w1, b1, "bias_snap_gelu_snap",
                                    Int8Sites(sm[1], sm[2]))
    dxn = K.gemm_f32x3_epilogue_plain(do2, wp.t(), None, "f32", Int8Sites())

    def mm(name, a, w, bias, epilogue, q, bars, residual=None):
        args = (a, w, bias, epilogue, q)
        return (f"gemm_f32x3_epilogue[{name}]",
                lambda: K.gemm_f32x3_epilogue_cuda(*args, residual=residual),
                lambda: K.gemm_f32x3_epilogue_plain(*args, residual=residual),
                bars)

    fc1_bar = series_bar(step[1][1], step[1][2])
    return [
        ("layernorm_snap_rows[int8]",
         lambda: K.layernorm_snap_rows_cuda(x2, s_a, b_a, Int8Sites(sa[0])),
         lambda: K.layernorm_snap_rows_plain(x2, s_a, b_a, Int8Sites(sa[0])),
         ((step[0][0], 1),)),
        mm("qkv,bias+site", xn, wqkv, bqkv, "bias_snap", Int8Sites(sa[1]),
           ((step[0][1], 1),)),
        ("attention_core_f32[site,stats]",
         lambda: K.attention_core_snap_cuda(qkv3, HEADS, SCALE,
                                            Int8Sites(sa[2]), stats=True),
         lambda: K.attention_core_snap_plain(qkv3, HEADS, SCALE,
                                             Int8Sites(sa[2]), stats=True),
         ((step[0][2], 1), "kernel", "kernel")),
        mm("proj,bias+site+residual+site", ctx.view(rows, C), wp, bp,
           "bias_snap_residual_snap", Int8Sites(sa[3], sa[4]),
           (series_bar(step[0][3], step[0][4]),), residual=x2),
        mm("fc1,bias+site+gelu+site", xm, w1, b1, "bias_snap_gelu_snap",
           Int8Sites(sm[1], sm[2]), (fc1_bar,)),
        mm("fc2,bias+site+residual+site", g, w2, mlp[5],
           "bias_snap_residual_snap", Int8Sites(sm[3], sm[4]),
           (series_bar(step[1][3], step[1][4]),), residual=x2),
        # GELU' of a flipped h moves by at most max|GELU''| (0.8) a step
        mm("fc1 remat,bias+site+gelu+site+gelu'", xm, w1, b1,
           "bias_snap_gelu_snap_grad", Int8Sites(sm[1], sm[2]),
           (fc1_bar, (step[1][1], 1))),
        ("layernorm_snap_rows_bwd[int8]",
         lambda: K.layernorm_rows_bwd_cuda(x2, s_a, dxn, do2, Int8Sites()),
         lambda: K.layernorm_rows_bwd_plain(x2, s_a, dxn, do2, Int8Sites()),
         ("kernel", "sum", "sum")),
    ]


def qat_int8_op_cases(x, attn, mlp, do, sites):
    """(name, kernel thunk, plain thunk, bars) of both INT8 QAT ops,
    forward and backward (the attention's with its qkv rows saved and
    recomputed), each backward from its own path's forward."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops import fused_attention_block as fa
    from myrtle_vision_tpu_torch.ops import fused_mlp as fm

    res = [fa._forward_q(kern, x, *attn, HEADS, SCALE, sites[0],
                         record=True)[1] for kern in (K.CUDA, K.PLAIN)]
    grads = ("chain",) + ("sum",) * 6
    chain = ((site_step(sites[0][4]), I8_CHAIN_STEPS),)

    def attn_back(kern, saved):
        ctx, m, rs, qkv = res[kern is K.PLAIN]
        return fa._backward_q(kern, do, x, *attn[:-1], ctx, m, rs,
                              qkv if saved else None, HEADS, SCALE, sites[0])

    return [
        ("fused_attention_block_i8",
         lambda: fa.fused_attention_block_i8(x, *attn, sites[0], HEADS,
                                             SCALE),
         lambda: fa.fused_attention_block_i8_plain(x, *attn, sites[0],
                                                   HEADS, SCALE), chain),
        ("fused_mlp_block_i8",
         lambda: fm.fused_mlp_block_i8(x, *mlp, sites[1]),
         lambda: fm.fused_mlp_block_i8_plain(x, *mlp, sites[1]),
         ((site_step(sites[1][4]), I8_CHAIN_STEPS),)),
        ("fused_attention_block_i8[bwd,saved qkv]",
         lambda: attn_back(K.CUDA, True), lambda: attn_back(K.PLAIN, True),
         grads),
        ("fused_attention_block_i8[bwd,recomputed qkv]",
         lambda: attn_back(K.CUDA, False), lambda: attn_back(K.PLAIN, False),
         grads),
        ("fused_mlp_block_i8[bwd]",
         lambda: fm._backward_q(K.CUDA, do, x, *mlp[:-1], sites[1]),
         lambda: fm._backward_q(K.PLAIN, do, x, *mlp[:-1], sites[1]), grads),
    ]


def phase_kernels_qat_int8(device):
    """Each kernel's INT8 mode and both INT8 QAT ops, forward and
    backward, against the plain versions at B=64, N=197, with calibrated
    sites and with row 2 of each half fresh; returns the largest abs error
    of each op, forward and backward, with calibrated sites."""
    errors = {}
    for fresh in (False, True):
        tag = "B=64,N=197, " + ("row 2 fresh" if fresh else "calibrated")
        x, attn, mlp, sites = qat_int8_block_inputs(64, N, seed=64197 + 5,
                                                    device=device,
                                                    fresh=fresh)
        do = seeded(np.random.RandomState(64197 + 6), (64, N, C), 1.0,
                    device)
        cases = (qat_int8_kernel_cases(x, attn, mlp, do, sites)
                 + qat_int8_op_cases(x, attn, mlp, do, sites))
        for name, kernel, plain, bars in cases:
            outs, refs = as_tuple(kernel()), as_tuple(plain())
            check(len(outs) == len(refs) == len(bars),
                  f"{name}: {len(outs)} outputs")
            worst, shares = (0.0, 0.0), []
            for i, (got, ref, kind) in enumerate(zip(outs, refs, bars)):
                label = f"qat-int8: {name} {tag} output {i}"
                if isinstance(kind, tuple):
                    step, steps = kind
                    same = (I8_CHAIN_SAME if steps == I8_CHAIN_STEPS
                            else I8_SAME)
                    max_abs, of_bar, share = compare_sites(
                        label, got, ref, step, steps, same)
                    shares.append(f"{share:.5f}")
                else:
                    max_abs, of_bar = compare(label, got, ref,
                                              *bar(kind, ref))
                worst = max(worst, (of_bar, max_abs))
            kinds = "/".join(k if isinstance(k, str) else
                             f"{k[1]} step(s) of {k[0]:.4g}" for k in bars)
            print(f"qat-int8: kernels: {name} {tag} max_abs {worst[1]:.6g}, "
                  f"{worst[0]:.4f} of the bar ({kinds}; shares past the "
                  f"fp32 noise {', '.join(shares) or 'n/a'})")
            if not fresh and name.startswith("fused_"):
                key = (name.split("[")[0]
                       + ("[bwd]" if "[bwd" in name else ""))
                errors[key] = max(errors.get(key, 0.0), worst[1])
        del x, attn, mlp, sites, do
    return errors


def long_int8_site(qkv, heads, scale):
    """The (scale, zero point, 1) row of an observer that has seen the
    fp32 context of ``qkv``, as a calibrated quant_out site."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.quantize import affine_uint8_qparams

    ctx = K.attention_context_f32(qkv, heads, scale)
    s, zp = affine_uint8_qparams(ctx.min(), ctx.max())
    return torch.stack([s, zp, torch.ones_like(s)])


def long_int8_case(b, n, d, heads, device, errors):
    """The long fp32 core's two int8 modes at B=b, N=n, ``heads`` heads of
    d against their plain versions with a calibrated quant_out site, each
    call's launches counted: the site snap with and without the
    statistics under the INT8 QAT site bar, the int8 grid under the
    converted INT8 bar, each with its share of flipped elements; the
    largest max abs difference of each mode into ``errors``."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    sites_key, out_key = LONG_INT8_KERNELS
    sc = d ** -0.5
    rng = np.random.RandomState(n * 100 + b)
    qkv = seeded(rng, (b, n, 3 * heads * d), 1.0, device)
    site = long_int8_site(qkv, heads, sc)
    plan = K.f32_long_plan(n, d, b, heads)
    design = (f"cluster design, {plan['fwd']['cluster']} CTAs a cluster"
              if plan["sweep"] else "score-block")
    tag = f"B={b} N={n} D={d} H={heads}"
    worst = (0.0, 0.0, 0.0)
    for stats in (False, True):
        got = as_tuple(counted(
            "attention_core_f32_long", K.F32_LONG_FWD_LAUNCHES,
            lambda: K.attention_core_snap_cuda(qkv, heads, sc,
                                               Int8Sites(site),
                                               stats=stats)))
        ref = as_tuple(K.attention_core_snap_plain(qkv, heads, sc,
                                                   Int8Sites(site),
                                                   stats=stats))
        label = f"{sites_key}{'+stats' if stats else ''} {tag}"
        max_abs, of_bar, share = compare_sites(f"{label} context", got[0],
                                               ref[0], site_step(site))
        for i in range(1, len(got)):
            m_abs, m_bar = compare(f"{label} output {i}", got[i], ref[i],
                                   RTOL, KERNEL_ATOL)
            max_abs, of_bar = max(max_abs, m_abs), max(of_bar, m_bar)
        worst = max(worst, (of_bar, max_abs, share))
    errors[sites_key] = max(errors[sites_key], worst[1])
    got = counted("attention_core_f32_long", K.F32_LONG_FWD_LAUNCHES,
                  lambda: K.attention_core_f32_cuda(qkv, heads, sc, site))
    ref = K.attention_core_f32_plain(qkv, heads, sc, site)
    g_abs, g_bar = compare_grid(f"{out_key} {tag}", got, ref, 1.0)
    flips = (got != ref).float().mean().item()
    errors[out_key] = max(errors[out_key], g_abs)
    print(f"kernels: {sites_key} {tag} ({design}; with and without "
          f"statistics) max_abs {worst[1]:.6g}, {worst[0]:.4f} of the bar, "
          f"{worst[2]:.6f} of the context past the fp32 noise (a flipped "
          f"rint of site step {site_step(site):.6g}); {out_key} max_abs "
          f"{g_abs:g} int8 steps, {g_bar:.4f} of the bar, {flips:.6f} of "
          f"the elements flipped (bar {1 - INT8_SAME:g})")


def phase_kernels_long_int8(device):
    """PyTorchINT8 above 256 tokens: the long fp32 core's two int8 modes
    against their plain versions (:func:`long_int8_case`) at
    :data:`LONG_INT8_CASES` (6 heads of 64) and past the score-block design
    at :data:`SWEEP_CASES` x batches 2 and 8 with a calibrated quant_out
    site, each call's launches counted (2, none of the one-CTA kernel's):
    the site snap with and without the statistics (K1 int8's core) under
    the INT8 QAT site bar, the int8 grid (K9's core) under the converted
    INT8 bar, each with its share of flipped elements; both forced at 197
    tokens (``tiled``, B=64) against
    the one-CTA kernel; then at 577 tokens (B=8) the INT8 QAT attention
    op forward and backward (K1 / K2 int8) and the converted attention
    op (K9) against their plain chains, their long core launches counted.
    Returns the largest max abs difference of each mode."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites

    errors = dict.fromkeys(LONG_INT8_KERNELS, 0.0)
    for b, n in LONG_INT8_CASES:
        long_int8_case(b, n, C // HEADS, HEADS, device, errors)
    for n, d, heads in SWEEP_CASES:
        for b in (2, 8):
            long_int8_case(b, n, d, heads, device, errors)

    # forced at 197 tokens, against the one-CTA kernel
    rng = np.random.RandomState(64197 + 9)
    qkv = seeded(rng, (64, N, 3 * C), 1.0, device)
    site = long_int8_site(qkv, HEADS, SCALE)
    long = counted("attention_core_f32_long",
                            K.F32_LONG_FWD_LAUNCHES,
                   lambda: K.attention_core_snap_cuda(
                       qkv, HEADS, SCALE, Int8Sites(site), stats=True,
                       tiled=True))
    short = K.attention_core_snap_cuda(qkv, HEADS, SCALE, Int8Sites(site),
                                       stats=True)
    worst = [compare_sites("forced long core site context", long[0],
                           short[0], site_step(site))[:2]]
    worst += [compare(f"forced long core site output {i}", long[i], short[i],
                      RTOL, KERNEL_ATOL) for i in (1, 2)]
    long = counted("attention_core_f32_long",
                            K.F32_LONG_FWD_LAUNCHES,
                   lambda: K.attention_core_f32_cuda(qkv, HEADS, SCALE, site,
                                                     tiled=True))
    short = K.attention_core_f32_cuda(qkv, HEADS, SCALE, site)
    worst.append(compare_grid("forced long core int8 grid", long, short,
                              1.0))
    print(f"kernels: the long f32 core's int8 modes forced at B=64,N=197 "
          f"against the one-CTA kernel: max_abs "
          f"{max(w[0] for w in worst):.6g}, {max(w[1] for w in worst):.4f} "
          f"of the bar")
    del qkv, long, short

    # the INT8 QAT attention op (K1 / K2 int8) and the converted attention
    # op (K9) at ViT-S/16's 384 px
    b, n = 8, 577
    x, attn, mlp, sites = qat_int8_block_inputs(b, n, seed=8577, device=device)
    do = seeded(np.random.RandomState(8578), (b, n, C), 1.0, device)
    for name, kernel, plain, bars in qat_int8_op_cases(x, attn, mlp, do,
                                                       sites):
        if not name.startswith("fused_attention_block_i8"):
            continue
        reset_counts()
        outs = as_tuple(kernel())
        launches = {k: v for k, v in read_counts()[0].items() if v}
        long_name = ("attention_core_f32_bwd_long" if "[bwd" in name
                     else "attention_core_f32_long")
        want = (K.F32_LONG_BWD_LAUNCHES if "[bwd" in name
                else K.F32_LONG_FWD_LAUNCHES)
        check(launches.get(long_name) == want
              and "attention_core_f32" not in launches
              and "attention_core_f32_bwd" not in launches,
              f"{name} at N={n}: launches {launches}")
        refs = as_tuple(plain())
        worst = (0.0, 0.0)
        for i, (got, ref, kind) in enumerate(zip(outs, refs, bars)):
            label = f"int8-long: {name} B={b} N={n} output {i}"
            if isinstance(kind, tuple):
                max_abs, of_bar, _ = compare_sites(label, got, ref, kind[0],
                                                   kind[1], I8_CHAIN_SAME)
            else:
                max_abs, of_bar = compare(label, got, ref, *bar(kind, ref))
            worst = max(worst, (of_bar, max_abs))
        print(f"kernels: {name} B={b} N={n} (the long core) max_abs "
              f"{worst[1]:.6g}, {worst[0]:.4f} of the bar; launches "
              f"{launches}")
    del x, attn, mlp, sites, do
    xi, ai, mi, ci = int8_block_inputs(b, n, seed=8579, device=device)
    for name, kernel, plain, step in int8_op_cases(xi, ai, mi, ci):
        reset_counts()
        got = kernel()
        launches = {k: v for k, v in read_counts()[0].items() if v}
        if name == "int8_attention_block":
            check(launches.get("attention_core_f32_long")
                  == K.F32_LONG_FWD_LAUNCHES
                  and "attention_core_f32" not in launches,
                  f"{name} at N={n}: launches {launches}")
        max_abs, of_bar = compare_grid(f"int8-long: {name} B={b} N={n}", got,
                                       plain(), step, INT8_CHAIN_SAME,
                                       INT8_CHAIN_STEPS)
        flips = (got != plain()).float().mean().item()
        print(f"kernels: {name} B={b} N={n} max_abs {max_abs:.6g}, "
              f"{of_bar:.4f} of the bar, {flips:.6f} of the elements "
              f"differ; launches {launches}")
    del xi, ai, mi, ci
    return errors


def phase_qat_int8(device, data_config, data_cfg):
    """The ViT-S/16 train CLI in PyTorchINT8 (two-pass QAT) through the
    INT8 QAT ops, forward and backward; its last checkpoint through the
    eval CLI (the simulation's eval forward) and the PTQ CLI (convert, the
    converted K9 / K10 forward).  Returns the op launches of the train
    run."""
    from myrtle_vision_tpu_torch.classification import test as eval_cli
    from myrtle_vision_tpu_torch.classification import test_quantize as ptq
    from myrtle_vision_tpu_torch.classification import train as train_cli

    config = vit_small_config()
    config["vit_config"]["q_format"] = "PyTorchINT8"
    tc = config["train_config"]
    tc.update(output_directory=os.path.join(WORK, "int8_qat"),
              checkpoint_path="", epochs=1, warmup_epochs=0,
              pretrained_backbone=None, iters_per_checkpoint=3,
              iters_per_val=3)
    config["data_config_path"] = data_cfg
    cfg = write_json("vit_small_qat_int8.json", config)
    depth = config["vit_config"]["depth"]

    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with counting_plain_calls() as plain_calls, \
            contextlib.redirect_stdout(out):
        state = train_cli.main(["-c", cfg, "--device", "cuda"])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("Iteration", "Epoch", "WARNING")):
            print(f"qat-int8: {line}")
    steps = state.iteration
    losses = [float(v) for v in
              re.findall(r"Iteration \d+:\tloss=(\S+)\tacc=", text)]
    with contextlib.redirect_stdout(io.StringIO()):
        model, train_loader, val_loader, (micro, n_accum) = \
            train_cli.build_train(config, device)
    validations = len(range(0, steps, tc["iters_per_val"]))
    per = depth * n_accum * steps  # validation runs no fused op
    print(f"qat-int8: ViT-S/16 train CLI in PyTorchINT8 on cuda, {steps} "
          f"steps of {n_accum} x {micro} images and {validations} "
          f"validations of {len(val_loader)} batch (the simulation's eval "
          f"forward) in {took:.1f} s: op launches (forward, backward) {ops}, "
          f"expected ({per}, {per}) of each INT8 QAT op ({depth} a "
          f"micro-batch) and none of another; plain-version calls "
          f"{plain_calls['n']}; kernels {launches}")
    check(steps >= 3 and len(losses) == steps, f"{steps} steps, {losses}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    for op, count in ops.items():
        want = (per, per) if op.endswith("_i8") else (0, 0)
        check(count == want, f"{op} launches {count}, expected {want}")
    check(plain_calls["n"] == 0, "the INT8 QAT run called a plain version")
    check(all(launches[k] > 0 for k in ("layernorm_snap_rows",
                                         "gemm_f32x3_epilogue",
                                         "attention_core_f32",
                                         "colsum_rows") + QAT_KERNELS),
          f"a kernel never launched: {launches}")
    check(launches["attention_core_f32"] == per
          and launches["attention_core_f32_bwd"] == per
          and launches["layernorm_snap_rows_bwd"] == 2 * per,
          f"kernel launches {launches}")

    run_dir = sorted(glob.glob(tc["output_directory"] + "_*"))[-1]
    ckpts = sorted(os.listdir(run_dir))
    check(ckpts == [f"vit_{i:06}" for i in range(0, steps, 3)]
          + [f"vit_{steps:06}"], f"checkpoints {ckpts}")
    first_step_check(model, train_loader, os.path.join(run_dir, "vit_000000"),
                     n_accum, micro, losses[0], tag="qat-int8")
    del model, train_loader, val_loader

    # the last checkpoint, observers and all, through the eval CLI and the
    # PTQ CLI
    tc["checkpoint_path"] = os.path.join(run_dir, ckpts[-1])
    tc["drop_last_batch"] = False
    cfg = write_json("vit_small_qat_int8_eval.json", config)
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        gts, preds, logits = eval_cli.main(["-c", cfg, "--device", "cuda"])
    _, ops_eval = read_counts()
    check(logits.shape == (len(gts), data_config["number_of_classes"])
          and bool(torch.isfinite(logits).all()), "eval of the checkpoint")
    check(all(v == (0, 0) for v in ops_eval.values()),
          f"the simulation's eval forward launched {ops_eval}")
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        gts_q, preds_q, logits_q = ptq.main(["-c", cfg, "--device", "cuda",
                                             "--calib_steps", "2"])
    launches_q, ops_q = read_counts()
    batches = math.ceil(len(gts_q) / micro)
    check(np.array_equal(gts, gts_q) and bool(torch.isfinite(logits_q).all()),
          "the PTQ CLI's test split")
    check(ops_q["int8_attention_block"] == (depth * batches, 0)
          and ops_q["int8_mlp_block"] == (depth * batches, 0),
          f"converted INT8 launches {ops_q}")
    print(f"qat-int8: checkpoint {ckpts[-1]} through the eval CLI (the INT8 "
          f"simulation): {len(gts)} test images, accuracy "
          f"{float(np.mean(gts == preds)):.4f}; through the PTQ CLI (2 more "
          f"calibration batches, convert, the converted K9 / K10 forward: "
          f"int8_attention_block {ops_q['int8_attention_block'][0]} "
          f"launches, gemm_s8_epilogue {launches_q['gemm_s8_epilogue']}): "
          f"accuracy {float(np.mean(gts_q == preds_q)):.4f}; the two argmax "
          f"agree on {float(np.mean(preds == preds_q)):.4f} of the images")
    return ops


def make_dataset_384():
    """A smaller synthetic RESISC-layout set (10 classes, 50 images each:
    350 train, 50 val, 100 test) and its data config at 384 px (96 px
    images resized up), for ViT-S/16 at 384 px: 577 tokens."""
    data = os.path.join(WORK, "data_384")
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "classification",
                                      "prepare_synthetic.py"),
         "--out", data, "--per_class", "50", "--seed", "11"],
        check=True, capture_output=True,
    )
    with open(os.path.join(ROOT, "classification", "data_configs",
                           "data_config_synth.json")) as f:
        data_config = json.load(f)
    data_config["dataset_path"] = data
    data_config["transform_ops_train"]["RandomResizedCrop"] = 384
    data_config["transform_ops_val"]["Resize"] = 384
    return data_config, write_json("data_config_384.json", data_config)


def int8_384_config(data_cfg, name):
    """vit_small.json in PyTorchINT8 at image_size 384 (its widths
    unchanged; the positional grid is interpolated from the config),
    written as ``name``."""
    config = vit_small_config()
    config["vit_config"].update(q_format="PyTorchINT8", image_size=384)
    config["data_config_path"] = data_cfg
    return config, write_json(name, config)


def phase_int8_384(device):
    """ViT-S/16 at 384 px (577 tokens) in PyTorchINT8: the train CLI (the
    two-pass QAT step, pass 2's fused ops through the long core's site
    mode) for one epoch of the 384 px set, its launches, the first step
    against the plain path; then its last checkpoint through the PTQ CLI
    (2 calibration batches, convert, the converted K9 / K10 forward, the
    core in the long core's int8 mode), its launches, and the converted
    model stage by stage and end to end against the plain path.  Returns
    (the train CLI's kernel launches, the PTQ CLI's, the converted
    checkpoint, the model's constructor kwargs)."""
    data_config, data_cfg = make_dataset_384()
    config, _ = int8_384_config(data_cfg, "vit_small_384_int8.json")
    return int8_train_and_ptq(device, data_config, config, "int8_384",
                              "int8-384", "ViT-S/16 at 384 px")


def int8_train_and_ptq(device, data_config, config, name, tag, label):
    """A PyTorchINT8 classifier ``config`` past 256 tokens through the
    train CLI for one epoch (the two-pass QAT step, pass 2's fused ops
    through the long core's site mode), its launches, no plain call, the
    first step against the plain path; then its last checkpoint through
    the PTQ CLI (2 calibration batches, convert, the converted K9 / K10
    forward, the core in the long core's int8 mode), its launches, and
    the converted model stage by stage and end to end against the plain
    path.  ``name`` names its files, ``tag`` leads its lines, ``label``
    names the model.  Returns (the train CLI's kernel launches, the PTQ
    CLI's, the converted checkpoint, the model's constructor kwargs)."""
    from myrtle_vision_tpu_torch.classification import test_quantize as ptq
    from myrtle_vision_tpu_torch.classification import train as train_cli
    from myrtle_vision_tpu_torch.classification.test import evaluate_dataset
    from myrtle_vision_tpu_torch.models.vit import ViT
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.utils.convert import (
        load_reference_checkpoint,
    )

    tc = config["train_config"]
    tc.update(output_directory=os.path.join(WORK, f"{name}_out"),
              checkpoint_path="", epochs=1, warmup_epochs=0,
              pretrained_backbone=None, iters_per_checkpoint=1000,
              iters_per_val=1000)
    cfg = write_json(f"{name}_train.json", config)
    depth = config["vit_config"]["depth"]
    size = config["vit_config"]["image_size"]

    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with counting_plain_calls() as plain_calls, \
            contextlib.redirect_stdout(out):
        state = train_cli.main(["-c", cfg, "--device", "cuda"])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("Iteration", "Epoch", "WARNING")):
            print(f"{tag}: {line}")
    steps = state.iteration
    losses = [float(v) for v in
              re.findall(r"Iteration \d+:\tloss=(\S+)\tacc=", text)]
    with contextlib.redirect_stdout(io.StringIO()):
        model, train_loader, val_loader, (micro, n_accum) = \
            train_cli.build_train(config, device)
    per = depth * n_accum * steps  # validation runs no fused op
    want = {"attention_core_f32_long": per * K.F32_LONG_FWD_LAUNCHES,
            "attention_core_f32_bwd_long": per * K.F32_LONG_BWD_LAUNCHES,
            "attention_core_f32": 0, "attention_core_f32_bwd": 0}
    got = {k: launches[k] for k in want}
    print(f"{tag}: {label} ({(size // 16) ** 2 + 1} tokens) "
          f"train CLI in PyTorchINT8 on cuda, {steps} steps of {n_accum} x "
          f"{micro} images and a validation of {len(val_loader)} batches "
          f"(the simulation's eval forward) in {took:.1f} s: op launches "
          f"(forward, backward) {ops}, expected ({per}, {per}) of each INT8 "
          f"QAT op; fp32 core launches {got}, expected {want}; plain-version "
          f"calls {plain_calls['n']}; kernels {launches}")
    check(steps >= 2 and len(losses) == steps, f"{steps} steps, {losses}")
    check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    for op, count in ops.items():
        check(count == ((per, per) if op.endswith("_i8") else (0, 0)),
              f"{op} launches {count}")
    check(plain_calls["n"] == 0, f"the {size} px INT8 QAT run called a "
          "plain version")
    check(got == want, f"the {size} px INT8 QAT step's long core launches")
    run_dir = sorted(glob.glob(tc["output_directory"] + "_*"))[-1]
    ckpts = sorted(os.listdir(run_dir))
    check(ckpts == ["vit_000000", f"vit_{steps:06}"], f"checkpoints {ckpts}")
    first_step_check(model, train_loader, os.path.join(run_dir, "vit_000000"),
                     n_accum, micro, losses[0], tag=tag)
    del model, train_loader, val_loader

    # the last checkpoint through the PTQ CLI: the converted model at 577
    # tokens, K9 / K10 with the long core's int8 mode
    saved = os.path.join(WORK, f"{name}_converted.pth")
    tc.update(checkpoint_path=os.path.join(run_dir, ckpts[-1]),
              drop_last_batch=False)
    cfg = write_json(f"{name}_ptq.json", config)
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        gts, preds, logits = ptq.main(["-c", cfg, "--device", "cuda",
                                       "--calib_steps", "2",
                                       "--save_converted", saved])
    ptq_launches, ops = read_counts()
    took = time.perf_counter() - t0
    batches = math.ceil(len(gts) / micro)
    expect = dict.fromkeys(ptq_launches, 0)
    expect.update(layernorm_quant_rows=(2 * depth + 1) * batches,
                  gemm_s8_epilogue=(4 * depth + 2) * batches,
                  attention_core_f32_long=depth * batches
                  * K.F32_LONG_FWD_LAUNCHES)
    print(f"{tag}: the PTQ CLI on {ckpts[-1]} in {took:.1f} s: "
          f"{len(gts)} test images in {batches} batches, accuracy "
          f"{float(np.mean(gts == preds)):.4f}; int8_attention_block "
          f"{ops['int8_attention_block'][0]} launches, kernels "
          f"{ {k: v for k, v in ptq_launches.items() if v} }")
    check(ops["int8_attention_block"] == ops["int8_mlp_block"]
          == (depth * batches, 0), f"converted INT8 launches {ops}")
    check(ptq_launches == expect, f"kernel launches {ptq_launches}, "
          f"expected {expect}")
    check(logits.shape == (len(gts), data_config["number_of_classes"])
          and bool(torch.isfinite(logits).all()), "converted logits")
    with open(cfg) as f:
        config = json.load(f)
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, test_loader, _, kwargs = ptq.build_quantize(config, device)
    model = ViT(**dict(kwargs, converted=True), device=device)
    model.load_state_dict(load_reference_checkpoint(saved), strict=True)
    model.eval()
    with torch.inference_mode():
        _, plain_preds, plain_logits = evaluate_dataset(
            lambda images: model(images, plain=True), test_loader)
    step = float(model.io_sites[3][0])
    stage_check(model, test_loader, tag=tag)
    # End to end the logits are held to the converted model's bar; the
    # argmax is printed, not held: this model's weights are random, two
    # steps from their seed, and its top-1 margins chance-level, so a
    # flip that the stage bars allow moves an argmax (measured: 2 of 40
    # images, H100 80GB HBM3, 700 W), where phase 6's model held 95%
    diff = (logits - plain_logits).abs()
    limit = INT8_LOGIT_BAR * max(1.0, plain_logits.abs().max().item())
    agree = float(np.mean(preds == plain_preds))
    print(f"{tag}: kernel vs plain converted logits max_abs "
          f"{diff.max().item():.6g} ({diff.max().item() / step:.3g} steps of "
          f"the head's grid {step:.6g}; bar {limit:.6g}), "
          f"{(diff == 0).float().mean().item():.4f} of them identical, "
          f"argmax agreement {agree:.4f} (printed, not held)")
    check(diff.max().item() <= limit,
          f"converted {size} px kernel-path logits disagree with the plain "
          "path")
    return launches, ptq_launches, saved, kwargs


# the converted model past the fused gate (phase ptq-gate): ViT-S/16 at
# 448 px, 785 tokens, past the 701 that fuses_at lets through at 6 heads
# of 64, and the batch of its timing line
GATE_SIZE = 448
GATE_BATCH = 32


def phase_ptq_gate(device, power, int8_ckpt):
    """The converted INT8 model past the fused gate, where the JAX model
    runs its discrete converted Block: the PTQ CLI on vit_small.json in
    PyTorchINT8 at 448 px (785 tokens), phase 4's weights, on the 384 px
    set's images resized to 448 px: 2 calibration batches, convert, the
    test split through the discrete Block (each projection through
    ``gemm_s8_epilogue``, each LayerNorm with statistics through
    ``layernorm_quant_rows``, the fp32 ``xla`` core and the requants as
    PyTorch operations); its launches, no fused op and no plain call; the
    converted forward stage by stage against the plain path (the kernel
    and chain bars), the CLI's logits against the plain path's (the
    converted model's end-to-end bar); both kernels at the path's
    shapes against their plain versions, timed; a timing line of the
    discrete forward at 448 px beside the fused one at 384 px; then the
    converted 224 px model of phase quantize fused and under
    ``MVT_INT8_FUSE=0``.  Returns (the PTQ CLI's kernel launches, {kernel:
    largest error against its plain version}, the kernels' timings per
    block at B=32)."""
    from myrtle_vision_tpu_torch.classification import test_quantize as cli
    from myrtle_vision_tpu_torch.classification.test import evaluate_dataset
    from myrtle_vision_tpu_torch.models.vit import ViT
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.attention import multi_head_attention
    from myrtle_vision_tpu_torch.ops.fused_attention_block import fuses_at
    from myrtle_vision_tpu_torch.utils.convert import (
        load_reference_checkpoint,
    )

    t_phase = time.perf_counter()
    tag = "ptq-gate"
    with open(os.path.join(WORK, "data_config_384.json")) as f:
        data_config = json.load(f)
    data_config["transform_ops_val"]["Resize"] = GATE_SIZE
    config = vit_small_config()
    vc, tc = config["vit_config"], config["train_config"]
    vc.update(q_format="PyTorchINT8", image_size=GATE_SIZE)
    config["data_config_path"] = write_json("data_config_448.json",
                                            data_config)
    tc.update(checkpoint_path=os.path.join(WORK, "vit_small_seed0.pth"),
              drop_last_batch=False)
    cfg = write_json("vit_small_int8_448.json", config)
    depth, heads, c = vc["depth"], vc["heads"], vc["embed_dim"]
    n = (GATE_SIZE // vc["patch_size"]) ** 2 + 1
    top = max(m for m in range(1, n) if fuses_at(m, heads, c // heads))
    check(not fuses_at(n, heads, c // heads), f"{tag}: {n} tokens fuse")

    saved = os.path.join(WORK, "vit_small_int8_448_converted.pth")
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with counting_plain_calls() as plain_calls, \
            contextlib.redirect_stdout(out):
        gts, preds, logits = cli.main(["-c", cfg, "--device", "cuda",
                                       "--calib_steps", "2",
                                       "--save_converted", saved])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    micro = tc["local_batch_size"]
    batches = math.ceil(len(gts) / micro)
    expect = dict.fromkeys(launches, 0)
    expect.update(layernorm_quant_rows=(2 * depth + 1) * batches,
                  gemm_s8_epilogue=(4 * depth + 2) * batches)
    print(f"{tag}: ViT-S/16 PTQ CLI (PyTorchINT8) at {GATE_SIZE} px, {n} "
          f"tokens past the fused gate's {top} at {heads} heads of "
          f"{c // heads}, on cuda in {took:.1f} s: {len(gts)} test images "
          f"in {batches} batches, accuracy {float(np.mean(gts == preds)):.4f};"
          f" op launches {ops}; plain-version calls {plain_calls['n']}; "
          f"kernels { {k: v for k, v in launches.items() if v} }, expected "
          f"{ {k: v for k, v in expect.items() if v} }")
    check(all(v == (0, 0) for v in ops.values()), f"{tag}: a fused op ran")
    check(launches == expect, f"{tag}: kernel launches {launches}")
    check(plain_calls["n"] == 0, f"{tag}: a plain version ran")
    check(logits.shape == (len(gts), data_config["number_of_classes"])
          and bool(torch.isfinite(logits).all()), f"{tag}: logits")

    with open(cfg) as f:
        config = json.load(f)
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, test_loader, _, kwargs = cli.build_quantize(config, device)
    model = ViT(**dict(kwargs, converted=True), device=device)
    model.load_state_dict(load_reference_checkpoint(saved), strict=True)
    model.eval()
    epoch = test_loader.epoch(0)
    img = next(epoch)["image"]
    epoch.close()
    # stage by stage under the kernel and chain bars; end to end, flips
    # compound over 12 blocks, so the CLI's logits are held to the
    # converted model's end-to-end bar against the plain path's, as in
    # phase quantize
    stage_check(model, test_loader, tag=tag)
    with torch.inference_mode():
        _, plain_preds, plain_logits = evaluate_dataset(
            lambda images: model(images, plain=True), test_loader)
    step = float(model.io_sites[3][0])
    diff = (logits - plain_logits).abs()
    limit = INT8_LOGIT_BAR * max(1.0, plain_logits.abs().max().item())
    agree = float(np.mean(preds == plain_preds))
    first = diff[:img.shape[0]]
    print(f"{tag}: kernel vs plain converted logits max_abs "
          f"{diff.max().item():.6g} ({diff.max().item() / step:.3g} steps of "
          f"the head's grid {step:.6g}; bar {limit:.6g}), "
          f"{(diff == 0).float().mean().item():.4f} of them identical "
          f"(the first batch: {(first == 0).float().mean().item():.4f}, "
          f"{first.max().item() / step:.3g} steps), argmax agreement "
          f"{agree:.4f} (bar {INT8_ARGMAX_BAR})")
    check(diff.max().item() <= limit and agree >= INT8_ARGMAX_BAR,
          f"{tag}: converted kernel-path logits disagree with the plain path")

    # both kernels at the path's shapes: block 0 of the first test batch,
    # each input from the plain path's own chain
    block = model.transformer.layers[0]
    sa, sm = model.block_sites[0]
    a, f = block._modules["0"].fn, block._modules["1"].fn
    qkv, o, fc1, fc2 = block._linears()
    with torch.inference_mode():
        x = model.embed_converted(img, K.PLAIN).reshape(-1, c)
        q8 = K.layernorm_quant_rows_plain(x, a.norm.weight, a.norm.bias,
                                          sa[0])
        y = K.gemm_s8_epilogue_plain(q8, qkv.weight.t(), qkv.weight_colsum,
                                     qkv.weight_scale, sa[0], qkv.bias,
                                     "requant", sa[1])
        qh, kh, vh = y.view(img.shape[0], n, 3, heads, -1).permute(
            2, 0, 3, 1, 4)
        ctx = multi_head_attention(qh, kh, vh, block.scale, impl="xla")
        c8 = K.quantize_i8(K.requant(ctx.transpose(1, 2).reshape(-1, c),
                                     sa[2]), sa[2])
        y = K.gemm_s8_epilogue_plain(c8, o.weight.t(), o.weight_colsum,
                                     o.weight_scale, sa[2], o.bias,
                                     "requant", sa[3])
        x1 = K.requant(y + x, sa[4])
        h8 = K.layernorm_quant_rows_plain(x1, f.norm.weight, f.norm.bias,
                                          sm[0])
        h = K.gemm_s8_epilogue_plain(h8, fc1.weight.t(), fc1.weight_colsum,
                                     fc1.weight_scale, sm[0], fc1.bias,
                                     "requant", sm[1])
        g8 = K.quantize_i8(K.requant(torch.nn.functional.gelu(h), sm[2]),
                           sm[2])
    totals, errors = {}, {}
    shape = f"B={img.shape[0]} N={n} (discrete converted Block)"

    def ln_case(xin, norm, site):
        return (lambda: K.layernorm_quant_rows_cuda(xin, norm.weight,
                                                    norm.bias, site),
                lambda: K.layernorm_quant_rows_plain(xin, norm.weight,
                                                     norm.bias, site),
                1.0, cost(nbytes(xin) * 5 // 4 + nbytes(norm.weight,
                                                        norm.bias),
                          10 * xin.numel(), "fp32"))

    def mm_case(ain, lin, a_site, site):
        args = (ain, lin.weight.t(), lin.weight_colsum, lin.weight_scale,
                a_site, lin.bias, "requant", site)
        w = lin.weight.t()
        m, kk, nn = ain.shape[0], ain.shape[1], w.shape[1]
        return (lambda: K.gemm_s8_epilogue_cuda(*args),
                lambda: K.gemm_s8_epilogue_plain(*args), float(site[0]),
                cost(nbytes(ain, w, lin.weight_colsum, lin.bias) + 4 * m * nn,
                     2 * m * nn * kk, "int8",
                     lambda: torch._int_mm(ain, w)))

    cases = [("layernorm_quant_rows[attn_norm]", ln_case(x, a.norm, sa[0])),
             ("layernorm_quant_rows[ffn_norm]", ln_case(x1, f.norm, sm[0])),
             ("gemm_s8_epilogue[qkv,requant]", mm_case(q8, qkv, sa[0], sa[1])),
             ("gemm_s8_epilogue[out,requant]", mm_case(c8, o, sa[2], sa[3])),
             ("gemm_s8_epilogue[fc1,requant]",
              mm_case(h8, fc1, sm[0], sm[1])),
             ("gemm_s8_epilogue[fc2,requant]",
              mm_case(g8, fc2, sm[2], sm[3]))]
    with torch.inference_mode():
        for name, (kernel, plain, grid, c_) in cases:
            max_abs, of_bar = compare_grid(f"{tag}: {name}", kernel(),
                                           plain(), grid)
            key = name.split("[")[0]
            errors[key] = max(errors.get(key, 0.0), max_abs)
            print(f"{tag}: {name} {shape} kernel vs plain: max_abs "
                  f"{max_abs:.6g}, {of_bar:.4f} of the INT8 bar")
            time_case(totals, name, kernel, plain, 1, c_, power, shape)

    # the discrete forward at 448 px beside the fused one at 384 px, the
    # same converted weights (the positions interpolated)
    gen = torch.Generator(device).manual_seed(448)
    fused = ViT(**dict(kwargs, image_size=384, converted=True),
                device=device)
    fused.load_state_dict(load_reference_checkpoint(saved), strict=True)
    fused.eval()
    groups = {"gemm_s8_epilogue": ("gemm_s8",),
              "layernorm_quant_rows": ("layernorm_quant_rows",),
              "attention_core_f32_long (int8 mode)": (
                  "f32_long_kv_split_kernel",
                  "attention_core_f32_long_kernel")}
    lines = []
    for net, size in ((model, GATE_SIZE), (fused, 384)):
        imgs = torch.randn(GATE_BATCH, size, size, 3, device=device,
                           generator=gen)
        with torch.inference_mode():
            ms = cuda_ms(lambda: net(imgs), iters=5, warmup=2)
            torch.cuda.reset_peak_memory_stats(device)
            net(imgs)
            peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
            profile = device_profile(lambda: net(imgs), groups)
        tokens = (size // 16) ** 2 + 1
        lines.append(f"{'discrete' if size == GATE_SIZE else 'fused'} Block "
                     f"at {size} px ({tokens} tokens) {ms:.3f} ms = "
                     f"{GATE_BATCH / ms * 1e3:.1f} img/s, peak "
                     f"{peak:.2f} GiB; {profile}")
        del imgs
    print(f"timing: converted INT8 ViT-S/16 forward B={GATE_BATCH} (CUDA "
          f"events, 5 calls): " + " | ".join(lines) + f" [{power}]")
    del fused, model

    # the converted 224 px model of phase quantize, fused and discrete
    with open(os.path.join(WORK, "vit_small_int8.json")) as f:
        config224 = json.load(f)
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, loader224, _, kw224 = cli.build_quantize(config224, device)
    conv = ViT(**dict(kw224, converted=True), device=device)
    conv.load_state_dict(load_reference_checkpoint(int8_ckpt), strict=True)
    conv.eval()
    runs = {}
    for mode in ("fused", "discrete"):
        if mode == "discrete":
            os.environ["MVT_INT8_FUSE"] = "0"
        reset_counts()
        try:
            with torch.inference_mode():
                runs[mode] = torch.cat([conv(batch["image"])
                                        for batch in loader224.epoch(0)])
        finally:
            os.environ.pop("MVT_INT8_FUSE", None)
        runs[mode + " ops"] = read_counts()[1]["int8_attention_block"][0]
    diff = (runs["fused"] - runs["discrete"]).abs()
    agree = (runs["fused"].argmax(-1) == runs["discrete"].argmax(-1)
             ).float().mean().item()
    print(f"{tag}: the converted 224 px model ({len(loader224.dataset)} "
          f"test images, the last batch padded) fused ({runs['fused ops']} int8_attention_block "
          f"launches) against MVT_INT8_FUSE=0 ({runs['discrete ops']}): "
          f"logits max |d| {diff.max().item():.6g} of a largest "
          f"{runs['fused'].abs().max().item():.4g}, "
          f"{(diff > 0).float().mean().item():.4f} of them differ (flips: "
          f"the kernels' polynomial erf and fused core against the exact "
          f"erf and the xla core), argmax agreement {agree:.4f} (printed, "
          f"not held)")
    check(runs["discrete ops"] == 0 and runs["fused ops"] > 0
          and bool(torch.isfinite(runs["discrete"]).all()),
          f"{tag}: MVT_INT8_FUSE=0 did not run the discrete Block")
    print(f"{tag}: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches, errors, totals


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
    expect = dict.fromkeys(launches, 0)  # every counter, probes too
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


def stage_check(model, loader, tag="quantize"):
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
            print(f"{tag}: stage {name}: {max_abs / step:.3g} steps of "
                  f"{step:.6g} at most, {differ:.5f} of the elements differ "
                  f"(bar {1 - same:g}, {steps} steps)")
            worst = max(worst, (of_bar, name))
    print(f"{tag}: the converted forward stage by stage (embedding, "
          f"{len(model.transformer.layers)} blocks, head), kernel path fed "
          f"the plain path's input: worst {worst[0]:.4f} of the bar, at "
          f"{worst[1]}")


def phase_quantize_float(device, data_config, data_cfg):
    """The PTQ CLI on vit_small.json in FP16_32 through the float-format
    kernels; returns (kernel launches of its run, the converted
    checkpoint's path, the model's constructor kwargs)."""
    from myrtle_vision_tpu_torch.classification import test_quantize as cli
    from myrtle_vision_tpu_torch.classification.test import evaluate_dataset
    from myrtle_vision_tpu_torch.models.vit import ViT
    from myrtle_vision_tpu_torch.utils.convert import (
        load_reference_checkpoint,
    )

    q_format, calib = "FP16_32", 2
    qspec = FLOAT_QSPECS[q_format]
    config = vit_small_config()
    config["vit_config"]["q_format"] = q_format
    fp32_ckpt = os.path.join(WORK, "vit_small_seed0.pth")  # phase 4's
    saved = os.path.join(WORK, "vit_small_fp16_32_converted.pth")
    config["data_config_path"] = data_cfg
    config["train_config"].update(checkpoint_path=fp32_ckpt,
                                  local_batch_size=32, drop_last_batch=False)
    cfg = write_json("vit_small_fp16_32.json", config)
    depth = config["vit_config"]["depth"]

    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        gts, preds, logits = cli.main(["-c", cfg, "--device", "cuda",
                                       "--calib_steps", str(calib),
                                       "--save_converted", saved])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        if "calibration" in line or "size" in line or "checkpoint" in line:
            print(f"quantize-float: {line.strip()}")
    with open(os.path.join(data_config["dataset_path"],
                           data_config["valid_files"])) as f:
        calib_batches = min(calib, math.ceil(len(f.read().split()) / 32))
    n_img = len(gts)
    batches = math.ceil(n_img / 32)
    forwards = calib_batches + batches
    float_ops = (ops["fused_attention_block"], ops["fused_mlp_block"])
    print(f"quantize-float: ViT-S/16 PTQ CLI ({q_format}) on cuda in "
          f"{took:.1f} s: {calib_batches} calibration batches through the "
          f"simulation forward, {n_img} test images in {batches} batches "
          f"through the converted one, accuracy "
          f"{float(np.mean(gts == preds)):.4f}: block-half ops (forward, "
          f"backward) {float_ops}, kernels {launches}")
    check(float_ops == ((depth * forwards, 0), (depth * forwards, 0)),
          f"block-half launches {float_ops}, expected {depth} per forward")
    # per forward: 2 LayerNorms, 4 products and one core per block; K11 at
    # the simulation forward's 4 weights a block, the embedding (act_in,
    # weight) and the head (norm act_in, act_in, weight), the converted
    # forward's also at the LayerNorm scales, and convert's at every
    # Linear and LayerNorm weight on the card
    expect = dict.fromkeys(launches, 0)  # every counter, probes too
    expect.update(layernorm_snap_rows=2 * depth * forwards,
                  gemm_f32x3_epilogue=4 * depth * forwards,
                  attention_core_f32=depth * forwards,
                  fake_quant_rows=calib_batches * (4 * depth + 5)
                  + (6 * depth + 3) + batches * (6 * depth + 6))
    check(launches == expect, f"kernel launches {launches}, expected {expect}")
    check(logits.shape == (n_img, data_config["number_of_classes"])
          and bool(torch.isfinite(logits).all()), "converted logits")
    ratio = os.path.getsize(saved) / os.path.getsize(fp32_ckpt)
    print(f"quantize-float: converted checkpoint {os.path.getsize(saved)} "
          f"bytes, {ratio:.4f} of the fp32 file (bar 0.6)")
    check(ratio < 0.6, "the converted checkpoint is not fp16-sized")

    # the written checkpoint, read as it is, through the plain versions
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, test_loader, _, kwargs = cli.build_quantize(config, device)
    model = ViT(**dict(kwargs, converted=True), device=device)
    state = load_reference_checkpoint(saved)
    check(state["transformer.layers.0.1.fn.fn.net.0.weight"].dtype
          == torch.float16, "converted weights are not fp16")
    model.load_state_dict(state, strict=True)
    model.eval()
    with torch.inference_mode():
        _, plain_preds, plain_logits = evaluate_dataset(
            lambda images: model(images, plain=True), test_loader)
    float_stage_check(model, test_loader, qspec)
    diff = (logits - plain_logits).abs().max().item()
    limit = LOGIT_BAR * max(1.0, plain_logits.abs().max().item())
    agree = float(np.mean(preds == plain_preds))
    print(f"quantize-float: kernel vs plain converted logits max_abs "
          f"{diff:.6g} (bar {limit:.6g}), argmax agreement {agree:.4f} (bar "
          f"{ARGMAX_BAR})")
    check(diff <= limit and agree >= ARGMAX_BAR,
          "converted float kernel-path logits disagree with the plain path")
    return launches, saved, kwargs


def float_stage_check(model, loader, qspec):
    """The converted float model's forward on the first test batch, stage
    by stage, each stage of the kernel path fed the plain path's input."""
    epoch = loader.epoch(0)
    img = next(epoch)["image"]
    epoch.close()
    q, conv = model.q_format, model.converted
    with torch.inference_mode():
        x = model.embed_float(img, plain=True)
        stages = [("embedding", model.embed_float(img), x, False)]
        for i, block in enumerate(model.transformer.layers):
            y = block.forward_float(x, plain=True)
            stages.append((f"block {i}", block.forward_float(x), y, True))
            x = y
        stages.append(("head", model.decoder.forward_float(x, q, conv, False),
                       model.decoder.forward_float(x, q, conv, True), True))
        for name, got, ref, chain in stages:
            max_abs, of_bar, share = compare_float(
                f"converted {name}", got, ref, qspec, chain=chain,
                hold_share=not chain)
            print(f"quantize-float: stage {name}: max_abs {max_abs:.6g}, "
                  f"{share:.5f} of the elements past the fp32 noise"
                  f"{'' if chain else ' (held)'}, {of_bar:.4f} of the "
                  f"{'step at the largest magnitude' if chain else 'kernel bar'}")


def make_detection_dataset():
    """The synthetic DIOR->COCO-layout set of detection/prepare_synthetic.py
    (3 classes; test split 96 images of 160 px) and DIOR's data config
    with it: the test transform resizes to 800 px (max 1333).  The one
    cut: 3 classes (a head of 4 outputs) in place of DIOR's 20 (21)."""
    data = os.path.join(WORK, "dior_synth")
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "detection",
                                      "prepare_synthetic.py"),
         "--root", data],
        check=True, capture_output=True,
    )
    with open(os.path.join(ROOT, "detection", "data_configs",
                           "data_config.json")) as f:
        data_config = json.load(f)
    data_config["dataset_path"] = data
    data_config["number_of_classes"] = 3
    return data_config, write_json("dior_synth_data_config.json",
                                   data_config)


def yolos_small_config():
    with open(os.path.join(ROOT, "detection", "train_configs",
                           "yolos_small.json")) as f:
        return json.load(f)


def phase_detect(device, data_config, data_cfg):
    """The YOLOS-S detection eval CLI through the flash kernel; returns
    the kernel launches of its run."""
    from myrtle_vision_tpu_torch.detection import test as cli
    from myrtle_vision_tpu_torch.models.detector import post_process
    from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config

    t0 = time.perf_counter()
    config = yolos_small_config()
    ckpt = os.path.join(WORK, "yolos_small_seed1.pth")
    config["data_config_path"] = data_cfg
    config["train_config"]["checkpoint_path"] = ckpt
    cfg = write_json("yolos_small_smoke.json", config)
    template = ViT(**vit_kwargs_from_config(config, data_config))
    torch.save(smoke_state_dict(template, seed=1), ckpt)
    del template
    depth = config["vit_config"]["depth"]
    batch = config["train_config"]["local_batch_size"]
    setup_s = time.perf_counter() - t0

    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        evaluator, preds = cli.main(["-c", cfg, "--device", "cuda"])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    n_img = len(preds)
    batches = math.ceil(n_img / batch)
    expect = dict.fromkeys(launches, 0)  # every counter, probes too
    expect["flash_attention_fwd"] = depth * batches
    print(f"detect: YOLOS-S detection eval CLI on cuda, {n_img} images in "
          f"{batches} batches of {batch} in {took:.1f} s (set-up: weights "
          f"{setup_s:.1f} s): flash_attention_fwd "
          f"{launches['flash_attention_fwd']} launches (expected "
          f"{depth} per batch, {depth * batches}), kernels {launches}, "
          f"block-half ops {ops}")
    check(n_img == 96, f"{n_img} test images")
    check(launches == expect, f"kernel launches {launches}, expected {expect}")
    check(all(v == (0, 0) for v in ops.values()),
          f"a fused block op ran at 2601 tokens: {ops}")
    stats = np.asarray(evaluator.stats, np.float64)
    print(f"detect: COCO summary (AP, AP50, AP75, APs, APm, APl, AR1, AR10, "
          f"AR100, ARs, ARm, ARl) {' '.join(f'{v:.4f}' for v in stats)}")
    check(stats.shape == (12,) and bool(np.isfinite(stats).all()),
          "COCO summary")

    # the same model and batches, kernel path against plain path
    with open(cfg) as f:
        config = json.load(f)
    model, loader, _ = cli.build_eval(config, device)
    model.eval()
    worst = {"pred_logits": (0.0, 0.0), "pred_boxes": (0.0, 0.0)}
    agree = total = 0
    cli_diff = largest = 0.0
    with torch.inference_mode():
        for b in loader.epoch(0):
            check(tuple(b["image"].shape[1:3]) == (800, 800),
                  f"image batch {tuple(b['image'].shape)}")
            got, ref = model(b["image"]), model(b["image"], plain=True)
            for key in worst:
                max_abs, of_bar = bar_share(f"detection {key}", got[key],
                                            ref[key], RTOL, CHAIN_ATOL)
                worst[key] = max(worst[key], (of_bar, max_abs))
            largest = max(largest, ref["pred_logits"].abs().max().item())
            agree += int((got["pred_logits"].argmax(-1)
                          == ref["pred_logits"].argmax(-1)).sum())
            total += got["pred_logits"].shape[0] * got["pred_logits"].shape[1]
            scores = post_process(got, b["orig_size"])["scores"].cpu().numpy()
            for i, img_id in enumerate(b["image_id"].tolist()):
                cli_diff = max(cli_diff, float(np.abs(
                    scores[i] - preds[img_id]["scores"]).max()))
    n_tok = (800 // 16) ** 2 + 1 + config["vit_config"]["num_det_tokens"]
    logit_limit = LOGIT_BAR * max(1.0, largest)
    print(f"detect: kernel vs plain path on the same batches ({n_tok} "
          f"tokens): pred_logits max_abs {worst['pred_logits'][1]:.6g} (bar "
          f"{logit_limit:.6g} = {LOGIT_BAR:g} of the largest, "
          f"{largest:.6g}; {worst['pred_logits'][0]:.4f} of the per-element"
          f" chain bar), pred_boxes max_abs {worst['pred_boxes'][1]:.6g} "
          f"({worst['pred_boxes'][0]:.4f} of the chain bar |d| <= "
          f"{RTOL:g}*|ref| + {CHAIN_ATOL:g}); argmax agreement "
          f"{agree / total:.4f} of {total} det tokens (bar "
          f"{DET_ARGMAX_BAR}); scores against the CLI's own max_abs "
          f"{cli_diff:.3g}")
    check(worst["pred_logits"][1] <= logit_limit,
          "detection logits: kernel path disagrees with the plain path")
    check(worst["pred_boxes"][0] <= 1.0,
          "detection boxes: kernel path disagrees with the plain path")
    check(agree / total >= DET_ARGMAX_BAR,
          "detection labels: kernel path disagrees with the plain path")
    check(cli_diff <= 1e-6, "the rerun kernel path is not the CLI's")
    return launches


def tokens_of(h, w):
    """YOLOS-S tokens of an h x w canvas: patches, cls, 100 det tokens."""
    return (h // 16) * (w // 16) + 1 + 100


def expected_train_launches(canvases, n_accum, depth, val_batches):
    """Kernel launches of an epoch that drew these step canvases (every
    micro-batch of a step shares its canvas), then a validation of
    ``val_batches`` batches at 800 px (discrete, the flash forward): per
    block and micro-batch, the fused path one attention core forward and
    its backward (four kernels above 256 tokens), the discrete path one
    flash forward and one flash backward (three kernels)."""
    from myrtle_vision_tpu_torch.ops.fused_attention_block import fuses_at

    want = {"attention_core": 0, "attention_core_bwd": 0,
            "flash_attention_fwd": depth * val_batches,
            "flash_attention_bwd": 0}
    for n in canvases:
        blocks = depth * n_accum
        if fuses_at(n, HEADS, C // HEADS):
            want["attention_core"] += blocks
            want["attention_core_bwd"] += blocks * (1 if n <= 256 else 4)
        else:
            want["flash_attention_fwd"] += blocks
            want["flash_attention_bwd"] += blocks * 3
    return want


def forced_batch(data_config, size, max_boxes, count=4):
    """The first ``count`` images of the train split resized to ``size``
    px (the longer side capped as DIOR's transform caps it), collated."""
    from myrtle_vision_tpu_torch.datasets.coco import CocoDetection
    from myrtle_vision_tpu_torch.transforms import detection as T

    root = data_config["dataset_path"]
    ds = CocoDetection(
        os.path.join(root, data_config["train_images"]),
        os.path.join(root, "annotations", data_config["train_annotations"]),
        T.from_config({"RandomResize": {"scales": [size],
                                        "max_size_ratio": [1333, 800]},
                       "Normalize": {"Mean": [0.5] * 3, "Std": [0.5] * 3}}))
    items = [ds.__getitem__(i, rng=np.random.default_rng((0, i)))
             for i in range(count)]
    return T.collate_detection(items, max_boxes=max_boxes)


def fp32_step_launches(n_tok, n_accum, depth):
    """The fused attention core's and the flash kernels' launches of one
    FP32 train step at ``n_tok`` tokens."""
    return expected_train_launches([n_tok], n_accum, depth, 0)


def forced_step_check(model, data_config, n_classes, weight_dict, eos_coef,
                      n_accum, micro, device, canvases=DET_CANVASES,
                      expect=fp32_step_launches, require=(),
                      phase="detect-train"):
    """The first step's loss and gradients at each of ``canvases`` (size,
    regime), kernel path against plain path, from the CLI's initial
    weights; the kernel path's launches as ``expect(tokens, n_accum,
    depth)`` gives them, and at least one of each kernel in ``require``;
    returns {size: launches}.  Both
    paths take the matches the plain path's outputs give, so that a
    near-tie in the matcher cannot part them, and both backpropagate the
    gradient of the plain path's loss at the outputs: the box losses have
    kinks (GIoU takes the max and min of the two boxes' edges), so a
    kernel-path box 3e-3 away from the plain one can move one coordinate's
    output gradient by about 1 where a predicted edge meets the target's,
    which says nothing of the kernels (the line prints the largest such
    difference of each path's own output gradient).  The loss itself is
    compared from each path's own outputs."""
    from myrtle_vision_tpu_torch.models.detector import criterion
    from myrtle_vision_tpu_torch.models.matcher import hungarian_match

    init = {n: t.detach().clone() for n, t in model.state_dict().items()}
    depth = len(model.transformer.layers)
    keys = ("pred_logits", "pred_boxes")
    step_launches = {}
    for size, regime in canvases:
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in forced_batch(data_config, size,
                                          model.num_det_tokens).items()}
        n_tok = tokens_of(*batch["image"].shape[1:3])
        micro_batches = [{k: v[i * micro:(i + 1) * micro]
                          for k, v in batch.items()} for i in range(n_accum)]
        matches, out_grads = [], []
        for mb in micro_batches:
            with torch.no_grad():
                out = model(mb["image"], plain=True)
            matches.append(hungarian_match(
                out["pred_logits"], out["pred_boxes"], mb["labels"],
                mb["boxes"], mb["valid"], cost_class=1.0, cost_bbox=5.0,
                cost_giou=2.0))
            leaves = {k: out[k].detach().requires_grad_() for k in keys}
            criterion(leaves, {k: mb[k] for k in ("labels", "boxes", "valid")},
                      n_classes, weight_dict=weight_dict, eos_coef=eos_coef,
                      src_idx=matches[-1])["loss"].backward()
            out_grads.append([leaves[k].grad for k in keys])
        runs = {}
        for plain in (False, True):
            model.load_state_dict(init)
            model.zero_grad(set_to_none=True)
            reset_counts()
            loss_sum, own = 0.0, 0.0
            for mb, src, grads in zip(micro_batches, matches, out_grads):
                out = model(mb["image"], plain=plain)
                leaves = {k: out[k].detach().requires_grad_() for k in keys}
                loss = criterion(
                    leaves, {k: mb[k] for k in ("labels", "boxes", "valid")},
                    n_classes, weight_dict=weight_dict, eos_coef=eos_coef,
                    src_idx=src)["loss"]
                loss.backward()
                loss_sum += loss.item()
                own = max(own, *((leaves[k].grad - g).abs().max().item()
                                 for k, g in zip(keys, grads)))
                torch.autograd.backward([out[k] for k in keys], grads)
            launches, _ = read_counts()
            runs[plain] = (loss_sum / n_accum, launches,
                           {n: p.grad.clone()
                            for n, p in model.named_parameters()
                            if p.grad is not None}, own)
        (k_loss, k_launch, k_grads, k_own), (p_loss, p_launch, p_grads, _) = \
            runs[False], runs[True]
        largest = max(g.abs().max().item() for gs in out_grads for g in gs)
        check(not any(p_launch.values()), f"plain path launched {p_launch}")
        want = expect(n_tok, n_accum, depth)
        got = {k: k_launch[k] for k in want}
        check(got == want and all(k_launch[k] > 0 for k in require),
              f"{size} px launches {k_launch}, expected {want} and "
              f"{require}")
        step_launches[size] = k_launch
        worst, worst_name = 0.0, ""
        for name, ref in p_grads.items():
            g = k_grads[name]
            check(bool(torch.isfinite(g).all()), f"non-finite grad {name}")
            rel = ((g - ref).norm() / ref.norm().clamp_min(1e-30)).item()
            if rel > worst:
                worst, worst_name = rel, name
        loss_diff = abs(k_loss - p_loss)
        print(f"{phase}: first step at {size} px ({n_tok} tokens, "
              f"{regime}), kernel vs plain: loss {k_loss:.6f} vs "
              f"{p_loss:.6f} (|d| {loss_diff:.3g}, bar "
              f"{LOSS_BAR * max(1.0, abs(p_loss)):.3g}), largest relative "
              f"gradient error {worst:.4g} in {worst_name} (bar {GRAD_BAR:g}) "
              f"over {len(p_grads)} tensors, both backpropagating the plain "
              f"path's output gradient (the kernel path's own differs by "
              f"{k_own:.4g} at most, of a largest {largest:.4g}); kernel "
              f"launches {got}")
        check(loss_diff <= LOSS_BAR * max(1.0, abs(p_loss)),
              f"{size} px first-step loss: kernel path disagrees")
        check(worst <= GRAD_BAR,
              f"{size} px first-step gradients: kernel path disagrees")
    model.load_state_dict(init)
    return step_launches


def phase_detect_train(device, data_config, data_cfg):
    """The YOLOS-S detection train CLI through the kernels; returns the
    kernel launches of its run."""
    from myrtle_vision_tpu_torch.detection import test as eval_cli
    from myrtle_vision_tpu_torch.detection import train as train_cli
    from myrtle_vision_tpu_torch.models.detector import build_weight_dict

    data_config = dict(data_config, train_subset=DET_TRAIN_SUBSET)
    data_cfg = write_json("dior_synth_train_data_config.json", data_config)
    config = yolos_small_config()
    tc = config["train_config"]
    # one epoch from scratch at the config's peak LR; no pretrained
    # backbone (it would need a download)
    tc.update(output_directory=os.path.join(WORK, "detect_train"),
              checkpoint_path="", epochs=1, warmup_epochs=0,
              pretrained_backbone=None)
    config["data_config_path"] = data_cfg
    cfg = write_json("yolos_small_train.json", config)
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
        if line.startswith(("Iteration", "Epoch", "WARNING", " Average")):
            print(f"detect-train: {line.strip()}")
    losses = [[float(v) for v in m] for m in re.findall(
        r"Iteration \d+:\tloss=(\S+)\tce=(\S+)\tbbox=(\S+)\tgiou=(\S+)",
        text)]

    # the CLI's set-up again: the same model, batches and micro-batching
    with contextlib.redirect_stdout(io.StringIO()):
        model, train_loader, val_loader, _, (micro, n_accum) = \
            train_cli.build_train(config, device)
    canvases = [tokens_of(*b["image"].shape[1:3])
                for b in train_loader.epoch(0)]
    steps = state.iteration
    want = expected_train_launches(canvases, n_accum, depth, len(val_loader))
    got = {k: launches[k] for k in want}
    print(f"detect-train: YOLOS-S train CLI on cuda, {steps} steps of "
          f"{n_accum} x {micro} images ({DET_TRAIN_SUBSET} of the train "
          f"split) and a validation of {len(val_loader)} batches at 800 px "
          f"in {took:.1f} s; step canvases in tokens {canvases}; launches "
          f"{got}, expected {want}; all kernels {launches}; block-half ops "
          f"{ops}")
    check(steps == len(canvases) == len(losses) == DET_TRAIN_SUBSET // 4,
          f"{steps} steps, {len(losses)} iteration lines")
    check(all(math.isfinite(v) for row in losses for v in row),
          f"losses {losses}")
    check(got == want, "detection training launches")
    check(launches["flash_attention_bwd"] > 0,
          "the epoch drew no canvas above the fused gate")

    run_dir = sorted(glob.glob(tc["output_directory"] + "_*"))[-1]
    ckpts = sorted(os.listdir(run_dir))
    check(ckpts == [f"vit_{steps:06}", "vit_best"], f"checkpoints {ckpts}")
    forced_step_check(model, data_config, data_config["number_of_classes"],
                      build_weight_dict(tc), tc["eos_coef"], n_accum, micro,
                      device)
    del model, train_loader, val_loader

    # vit_best, as written, through the detection eval CLI (test split)
    tc["checkpoint_path"] = os.path.join(run_dir, "vit_best")
    cfg = write_json("yolos_small_trained_eval.json", config)
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        evaluator, preds = eval_cli.main(["-c", cfg, "--device", "cuda"])
    eval_launches, _ = read_counts()
    stats = np.asarray(evaluator.stats, np.float64)
    batches = math.ceil(len(preds) / tc["local_batch_size"])
    print(f"detect-train: vit_best through the detection eval CLI: "
          f"{len(preds)} test images, COCO summary "
          f"{' '.join(f'{v:.4f}' for v in stats)}, flash_attention_fwd "
          f"{eval_launches['flash_attention_fwd']} launches")
    check(stats.shape == (12,) and bool(np.isfinite(stats).all()),
          "COCO summary of the trained checkpoint")
    check(eval_launches["flash_attention_fwd"] == depth * batches
          and eval_launches["flash_attention_bwd"] == 0,
          f"eval launches {eval_launches}")
    return launches


def float_step_launches(n_tok, n_accum, depth, heads=HEADS, d=C // HEADS):
    """The fp32 attention core's launches of one float-format (or float32
    compute) train step at ``n_tok`` tokens, ``heads`` heads of d: per
    block and micro-batch, where the Block fuses above 256 tokens, one
    long forward (with the statistics; two kernels) and one long backward
    (four kernels); past the gate none (the discrete Block's core is
    PyTorch operations, or the fp32 flash kernels in float32 compute,
    which these steps never reach); never a one-CTA or a flash kernel."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.fused_attention_block import fuses_at

    fused = fuses_at(n_tok, heads, d)
    calls = depth * n_accum if fused and n_tok > K.F32_CORE_MAX_N else 0
    return {"attention_core_f32_long": calls * K.F32_LONG_FWD_LAUNCHES,
            "attention_core_f32_bwd_long": calls * K.F32_LONG_BWD_LAUNCHES,
            "attention_core_f32": 0, "attention_core_f32_bwd": 0,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0,
            "flash_attention_f32_fwd": 0, "flash_attention_f32_bwd": 0}


def float_detection_config(data_cfg, name):
    """yolos_small.json with q_format FP16_32 (no pretrained backbone),
    written as ``name``."""
    config = yolos_small_config()
    config["vit_config"]["q_format"] = "FP16_32"
    config["data_config_path"] = data_cfg
    config["train_config"]["pretrained_backbone"] = None
    return config, write_json(name, config)


def phase_detect_float(device, data_config, data_cfg):
    """YOLOS-S in FP16_32 (yolos_small.json with q_format FP16_32, random
    weights from a seed): the 800 px eval forward at batch 8 (the discrete
    float Block: K11 at its sites, no fused op) against the plain path; the
    first QAT step at :data:`FLOAT_DET_CANVASES` against the plain path
    (the long kernels at 384 px, counted); the train CLI for one epoch of
    32 synthetic images at :data:`FLOAT_TRAIN_SCALES` (every step through
    the long kernels, counted), its validation at 800 px, and its last
    checkpoint through the eval CLI.  Returns the train CLI's kernel
    launches."""
    from myrtle_vision_tpu_torch.detection import test as eval_cli
    from myrtle_vision_tpu_torch.detection import train as train_cli
    from myrtle_vision_tpu_torch.models.detector import build_weight_dict
    from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config

    t0 = time.perf_counter()
    config, _ = float_detection_config(data_cfg, "yolos_small_fp16_32.json")
    tc = config["train_config"]
    depth = config["vit_config"]["depth"]
    model = ViT(**vit_kwargs_from_config(config, data_config), device=device)
    model.load_state_dict(smoke_state_dict(model, seed=2))

    # the 800 px eval at batch 8, kernel path against plain path
    imgs = torch.from_numpy(forced_batch(data_config, 800, 100, 8)["image"]
                            ).to(device)
    model.eval()
    with torch.inference_mode():
        reset_counts()
        got = model(imgs)
        launches, ops = read_counts()
        ref = model(imgs, plain=True)
    check(launches["fake_quant_rows"] > 0
          and all(v == 0 for k, v in launches.items()
                  if k != "fake_quant_rows")
          and all(v == (0, 0) for v in ops.values()),
          f"800 px FP16_32 eval launches {launches}, ops {ops}")
    largest = ref["pred_logits"].abs().max().item()
    logit_diff, _ = bar_share("FP16_32 detection logits", got["pred_logits"],
                              ref["pred_logits"], RTOL, CHAIN_ATOL)
    box_diff, box_bar = bar_share("FP16_32 detection boxes",
                                  got["pred_boxes"], ref["pred_boxes"], RTOL,
                                  CHAIN_ATOL)
    agree = (got["pred_logits"].argmax(-1)
             == ref["pred_logits"].argmax(-1)).double().mean().item()
    print(f"detect-float: YOLOS-S FP16_32 eval forward at 800 px "
          f"({tokens_of(800, 800)} tokens, the discrete float Block) B=8, "
          f"kernel vs plain path: pred_logits max_abs {logit_diff:.6g} (bar "
          f"{LOGIT_BAR * max(1.0, largest):.6g}), pred_boxes max_abs "
          f"{box_diff:.6g} ({box_bar:.4f} of the chain bar), argmax "
          f"agreement {agree:.4f}; fake_quant_rows "
          f"{launches['fake_quant_rows']} launches, no other kernel")
    check(logit_diff <= LOGIT_BAR * max(1.0, largest) and box_bar <= 1.0
          and agree >= DET_ARGMAX_BAR,
          "FP16_32 detection eval: kernel path disagrees with the plain path")
    del imgs, got, ref

    # the first QAT step at 384 and 608 px, kernel path against plain path
    model.train()
    step_launches = forced_step_check(
        model, data_config, data_config["number_of_classes"],
        build_weight_dict(tc), tc["eos_coef"], 2, 2, device,
        canvases=FLOAT_DET_CANVASES, expect=float_step_launches,
        require=("fake_quant_rows",), phase="detect-float")
    del model
    setup_s = time.perf_counter() - t0

    # the train CLI at 288-352 px, then its checkpoint through the eval CLI
    train_data = dict(data_config, train_subset=DET_TRAIN_SUBSET)
    train_data["transform_ops_train"] = {
        "RandomHorizontalFlip": None,
        "RandomResize": {"scales": FLOAT_TRAIN_SCALES,
                         "max_size_ratio": [1333, 800]},
        "Normalize": data_config["transform_ops_train"]["Normalize"]}
    train_cfg = write_json("dior_synth_float_train_data_config.json",
                           train_data)
    config, _ = float_detection_config(train_cfg, "yolos_small_fp16_32.json")
    tc = config["train_config"]
    tc.update(output_directory=os.path.join(WORK, "detect_float"),
              checkpoint_path="", epochs=1, warmup_epochs=0)
    cfg = write_json("yolos_small_fp16_32_train.json", config)
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = train_cli.main(["-c", cfg, "--device", "cuda"])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("Iteration", "Epoch")):
            print(f"detect-float: {line.strip()}")
    losses = [[float(v) for v in m] for m in re.findall(
        r"Iteration \d+:\tloss=(\S+)\tce=(\S+)\tbbox=(\S+)\tgiou=(\S+)",
        text)]
    with contextlib.redirect_stdout(io.StringIO()):
        _, train_loader, val_loader, _, (micro, n_accum) = \
            train_cli.build_train(config, device)
    canvases = [tokens_of(*b["image"].shape[1:3])
                for b in train_loader.epoch(0)]
    steps = state.iteration
    want = dict.fromkeys(float_step_launches(canvases[0], n_accum, depth), 0)
    for n in canvases:
        for k, v in float_step_launches(n, n_accum, depth).items():
            want[k] += v
    got = {k: launches[k] for k in want}
    print(f"detect-float: YOLOS-S FP16_32 train CLI on cuda, {steps} steps "
          f"of {n_accum} x {micro} images ({DET_TRAIN_SUBSET} of the train "
          f"split at {FLOAT_TRAIN_SCALES} px) and a validation of "
          f"{len(val_loader)} batches at 800 px in {took:.1f} s (the steps "
          f"and set-up before it: {setup_s:.1f} s); step canvases in tokens "
          f"{canvases}; launches {got}, expected {want}; all kernels "
          f"{launches}; block-half ops {ops}")
    check(steps == len(canvases) == len(losses) == DET_TRAIN_SUBSET // 4,
          f"{steps} steps, {len(losses)} iteration lines")
    check(all(math.isfinite(v) for row in losses for v in row),
          f"losses {losses}")
    check(all(256 < n <= 701 for n in canvases), f"canvases {canvases}")
    check(got == want, "FP16_32 detection training launches")
    run_dir = sorted(glob.glob(tc["output_directory"] + "_*"))[-1]
    ckpts = sorted(os.listdir(run_dir))
    check(ckpts == [f"vit_{steps:06}", "vit_best"], f"checkpoints {ckpts}")
    ckpt = os.path.join(run_dir, f"vit_{steps:06}")
    check(torch.load(ckpt, weights_only=True)["q_format"] == "FP16_32",
          "the checkpoint's q_format")
    tc["checkpoint_path"] = ckpt
    cfg = write_json("yolos_small_fp16_32_eval.json", config)
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        evaluator, preds = eval_cli.main(["-c", cfg, "--device", "cuda"])
    eval_launches, eval_ops = read_counts()
    stats = np.asarray(evaluator.stats, np.float64)
    print(f"detect-float: vit_{steps:06} through the detection eval CLI in "
          f"FP16_32: {len(preds)} test images at 800 px, COCO summary "
          f"{' '.join(f'{v:.4f}' for v in stats)}, fake_quant_rows "
          f"{eval_launches['fake_quant_rows']} launches, block-half ops "
          f"{eval_ops}")
    check(stats.shape == (12,) and bool(np.isfinite(stats).all()),
          "COCO summary of the FP16_32 checkpoint")
    check(eval_launches["fake_quant_rows"] > 0
          and all(v == (0, 0) for v in eval_ops.values()),
          f"FP16_32 eval launches {eval_launches}")
    print(f"detect-float: the 384 px QAT step's launches "
          f"{ {k: v for k, v in step_launches[384].items() if v} }")
    return launches


# YOLOS-Ti (detection/train_configs/yolos_tiny.json: dim 192, 3 heads of
# 64, MLP 768, 100 detection tokens), which the fused gate fuses up to
# 1017 tokens: the train CLI's canvases past the long fp32 core's score
# block, (px, train images): 2 steps of 2 x 2 at 480 px (1001 tokens), then
# 1 at 464 px (942), resumed from the first run's checkpoint, each run
# validating TINY_VALID images at its own canvas; and vit_tiny.json's
# widths at image_size 480 (901 tokens) in PyTorchINT8
TINY_RUNS = ((480, 8), (464, 4))
TINY_VALID = 4
TINY_INT8_SIZE = 480
# YOLOS-Ti's step launches (3 heads of 64)
tiny_step_launches = functools.partial(float_step_launches, heads=3, d=64)


def yolos_tiny_config(data_cfg, q_format="FP16_32", compute_dtype=None):
    """yolos_tiny.json in ``q_format`` (no pretrained backbone), reading
    ``data_cfg``; float32 compute where ``compute_dtype`` says so."""
    with open(os.path.join(ROOT, "detection", "train_configs",
                           "yolos_tiny.json")) as f:
        config = json.load(f)
    config["vit_config"]["q_format"] = q_format
    if compute_dtype is not None:
        config["vit_config"]["compute_dtype"] = compute_dtype
    config["data_config_path"] = data_cfg
    config["train_config"]["pretrained_backbone"] = None
    return config


def make_dataset_480():
    """A small synthetic RESISC-layout set (10 classes, 40 images each:
    280 train, 40 val, 80 test) and its data config at 480 px (96 px
    images resized up)."""
    data = os.path.join(WORK, "data_480")
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "classification",
                                      "prepare_synthetic.py"),
         "--out", data, "--per_class", "40", "--seed", "13"],
        check=True, capture_output=True,
    )
    with open(os.path.join(ROOT, "classification", "data_configs",
                           "data_config_synth.json")) as f:
        data_config = json.load(f)
    data_config["dataset_path"] = data
    data_config["transform_ops_train"]["RandomResizedCrop"] = TINY_INT8_SIZE
    data_config["transform_ops_val"]["Resize"] = TINY_INT8_SIZE
    return data_config, write_json("data_config_480.json", data_config)


def phase_detect_tiny(device, data_config, data_cfg):
    """The fused block's long fp32 core past its score block (the forward's
    cluster design) on the main paths, at yolos_tiny.json's and
    vit_tiny.json's widths.  YOLOS-Ti in FP16_32 (random weights from a
    seed): the first QAT step at 480 and 464 px (1001 and 942 tokens)
    kernel path against plain path, launches counted; the same at 480 px
    in float32 compute (the fused fp32 route, no snap); the train CLI for
    2 steps at 480 px and, resumed from its checkpoint, 1 at 464 px, each
    validating at its canvas (the eval forward fused too): the long core's
    launches against the canvases, no plain call, finite losses.  Then
    vit_tiny.json's widths at 480 px (901 tokens) in PyTorchINT8 through
    the train CLI (the two-pass QAT step) and the PTQ CLI (the converted
    forward), as :func:`int8_train_and_ptq` holds them.  Returns the
    FP16_32 train CLI runs' kernel launches, summed."""
    from myrtle_vision_tpu_torch.detection import train as train_cli
    from myrtle_vision_tpu_torch.models.detector import build_weight_dict
    from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
    from myrtle_vision_tpu_torch.ops import _kernels as K

    t0 = time.perf_counter()
    n_classes = data_config["number_of_classes"]
    for q_format, dtype, canvases in (
            ("FP16_32", None, ((480, "fused, the cluster long core"),
                               (464, "fused, the cluster long core"))),
            ("FP32", "float32", ((480, "fused fp32 route, the cluster "
                                       "long core without a snap"),))):
        config = yolos_tiny_config(data_cfg, q_format, dtype)
        tc = config["train_config"]
        model = ViT(**vit_kwargs_from_config(config, data_config),
                    device=device)
        model.load_state_dict(smoke_state_dict(model, seed=7))
        model.train()
        forced_step_check(
            model, data_config, n_classes, build_weight_dict(tc),
            tc["eos_coef"], 2, 2, device, canvases=canvases,
            expect=tiny_step_launches,
            require=("fake_quant_rows",) if dtype is None else (),
            phase=f"detect-tiny {q_format if dtype is None else dtype}")
        del model

    # the train CLI: 2 steps at 480 px, then 1 at 464 px from its checkpoint
    norm = data_config["transform_ops_train"]["Normalize"]
    total = {}
    ckpt = ""
    for run, (size, images) in enumerate(TINY_RUNS):
        resize = {"scales": [size], "max_size_ratio": [1333, 800]}
        run_data = dict(data_config, train_subset=images,
                        valid_subset=TINY_VALID)
        run_data["transform_ops_train"] = {"RandomHorizontalFlip": None,
                                           "RandomResize": resize,
                                           "Normalize": norm}
        run_data["transform_ops_val"] = {"RandomResize": resize,
                                         "Normalize": norm}
        run_cfg = write_json(f"dior_synth_tiny_{size}.json", run_data)
        config = yolos_tiny_config(run_cfg)
        tc = config["train_config"]
        tc.update(output_directory=os.path.join(WORK, f"detect_tiny_{size}"),
                  checkpoint_path=ckpt, epochs=run + 1, warmup_epochs=0)
        cfg = write_json(f"yolos_tiny_fp16_32_{size}.json", config)
        depth = config["vit_config"]["depth"]
        reset_counts()
        out = io.StringIO()
        t1 = time.perf_counter()
        with counting_plain_calls() as plain_calls, \
                contextlib.redirect_stdout(out):
            state = train_cli.main(["-c", cfg, "--device", "cuda"])
        launches, ops = read_counts()
        took = time.perf_counter() - t1
        text = out.getvalue()
        losses = [[float(v) for v in m] for m in re.findall(
            r"Iteration \d+:\tloss=(\S+)\tce=(\S+)\tbbox=(\S+)\tgiou=(\S+)",
            text)]
        for line in text.splitlines():
            if line.startswith(("Iteration", "Epoch")):
                print(f"detect-tiny: {line.strip()}")
        with contextlib.redirect_stdout(io.StringIO()):
            _, train_loader, val_loader, _, (micro, n_accum) = \
                train_cli.build_train(config, device)
        canvases = [tokens_of(*b["image"].shape[1:3])
                    for b in train_loader.epoch(run)]
        want = dict.fromkeys(tiny_step_launches(canvases[0], n_accum, depth),
                             0)
        for n in canvases:
            for k, v in tiny_step_launches(n, n_accum, depth).items():
                want[k] += v
        # the validation's eval forward: one long forward a block and batch
        want["attention_core_f32_long"] += (depth * len(val_loader)
                                            * K.F32_LONG_FWD_LAUNCHES)
        got = {k: launches[k] for k in want}
        steps = len(canvases)
        print(f"detect-tiny: YOLOS-Ti FP16_32 train CLI on cuda, run "
              f"{run + 1}: {steps} steps of {n_accum} x {micro} images at "
              f"{size} px (tokens {canvases}) from "
              f"{'scratch' if not ckpt else os.path.basename(ckpt)}, then "
              f"a validation of {len(val_loader)} batches at {size} px, in "
              f"{took:.1f} s; launches {got}, expected {want}; plain-version "
              f"calls {plain_calls['n']}; all kernels "
              f"{ {k: v for k, v in launches.items() if v} }; block-half ops "
              f"{ops}")
        check(len(losses) == steps == images // (n_accum * micro)
              and state.iteration == sum(i for _, i in TINY_RUNS[:run + 1])
              // (n_accum * micro), f"{steps} steps, {losses}, iteration "
              f"{state.iteration}")
        check(all(math.isfinite(v) for row in losses for v in row),
              f"losses {losses}")
        check(all(n == tokens_of(size, size) for n in canvases)
              and tokens_of(size, size) > 768, f"canvases {canvases}")
        check(got == want, "YOLOS-Ti FP16_32 training launches")
        check(plain_calls["n"] == 0, "the YOLOS-Ti FP16_32 run called a "
              "plain version")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        run_dir = sorted(glob.glob(tc["output_directory"] + "_*"))[-1]
        ckpt = os.path.join(run_dir, f"vit_{state.iteration:06}")
        check(os.path.exists(ckpt), f"no checkpoint {ckpt}")
        del train_loader, val_loader

    # vit_tiny.json's widths at 480 px in PyTorchINT8: the train and PTQ
    # CLIs
    i8_data, i8_cfg = make_dataset_480()
    with open(os.path.join(ROOT, "classification", "train_configs",
                           "vit_tiny.json")) as f:
        config = json.load(f)
    config["vit_config"].update(q_format="PyTorchINT8",
                                image_size=TINY_INT8_SIZE)
    config["data_config_path"] = i8_cfg
    int8_train_and_ptq(device, i8_data, config, "int8_tiny_480",
                       "detect-tiny int8", "vit_tiny.json's widths at 480 px")
    print(f"detect-tiny: phase took {time.perf_counter() - t0:.1f} s")
    return total


def phase_detect_int8(device, data_config, data_cfg):
    """YOLOS-S in PyTorchINT8 (yolos_small.json with q_format PyTorchINT8,
    random weights from the seed): the train CLI (the JAX one-pass QAT
    step: the calibrating forward differentiated, the discrete Block at
    every canvas, PyTorch operations as XLA runs them in the JAX package,
    no kernel of the port) for one epoch of 32 synthetic images at
    :data:`FLOAT_TRAIN_SCALES`, its validation at 800 px (the
    simulation's eval forward), and its last checkpoint, observers and
    all, through the detection eval CLI; no kernel launches."""
    from myrtle_vision_tpu_torch.detection import test as eval_cli
    from myrtle_vision_tpu_torch.detection import train as train_cli
    from myrtle_vision_tpu_torch.quantize import is_observer

    train_data = dict(data_config, train_subset=DET_TRAIN_SUBSET)
    train_data["transform_ops_train"] = {
        "RandomHorizontalFlip": None,
        "RandomResize": {"scales": FLOAT_TRAIN_SCALES,
                         "max_size_ratio": [1333, 800]},
        "Normalize": data_config["transform_ops_train"]["Normalize"]}
    train_cfg = write_json("dior_synth_int8_train_data_config.json",
                           train_data)
    config = yolos_small_config()
    config["vit_config"]["q_format"] = "PyTorchINT8"
    config["data_config_path"] = train_cfg
    tc = config["train_config"]
    tc.update(output_directory=os.path.join(WORK, "detect_int8"),
              checkpoint_path="", epochs=1, warmup_epochs=0,
              pretrained_backbone=None)
    cfg = write_json("yolos_small_int8_train.json", config)
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = train_cli.main(["-c", cfg, "--device", "cuda"])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("Iteration", "Epoch")):
            print(f"detect-int8: {line.strip()}")
    losses = [[float(v) for v in m] for m in re.findall(
        r"Iteration \d+:\tloss=(\S+)\tce=(\S+)\tbbox=(\S+)\tgiou=(\S+)",
        text)]
    steps = state.iteration
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"detect-int8: YOLOS-S PyTorchINT8 train CLI on cuda, {steps} "
          f"steps of {DET_TRAIN_SUBSET // steps if steps else 0} images "
          f"({DET_TRAIN_SUBSET} of the train split at {FLOAT_TRAIN_SCALES} "
          f"px) and a validation at 800 px in {took:.1f} s; kernels "
          f"launched { {k: v for k, v in launches.items() if v} } (none "
          f"expected: the JAX detector runs no Pallas kernel in "
          f"PyTorchINT8), block-half ops {ops}; peak device memory since "
          f"the last reset {peak:.2f} GiB")
    check(steps == len(losses) == DET_TRAIN_SUBSET // 4,
          f"{steps} steps, {len(losses)} iteration lines")
    check(all(math.isfinite(v) for row in losses for v in row),
          f"losses {losses}")
    check(all(v == 0 for v in launches.values())
          and all(v == (0, 0) for v in ops.values()),
          f"INT8 detection training launched {launches}, {ops}")
    run_dir = sorted(glob.glob(tc["output_directory"] + "_*"))[-1]
    ckpts = sorted(os.listdir(run_dir))
    check(ckpts == [f"vit_{steps:06}", "vit_best"], f"checkpoints {ckpts}")
    ckpt = os.path.join(run_dir, f"vit_{steps:06}")
    payload = torch.load(ckpt, weights_only=True)
    observers = {n: float(t) for n, t in payload["model"].items()
                 if is_observer(n)}
    check(payload["q_format"] == "PyTorchINT8" and observers
          and all(math.isfinite(v) for v in observers.values()),
          "the INT8 checkpoint's format and observers")
    tc["checkpoint_path"] = ckpt
    config["data_config_path"] = data_cfg
    cfg = write_json("yolos_small_int8_eval.json", config)
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        evaluator, preds = eval_cli.main(["-c", cfg, "--device", "cuda"])
    eval_launches, eval_ops = read_counts()
    stats = np.asarray(evaluator.stats, np.float64)
    print(f"detect-int8: vit_{steps:06} ({len(observers) // 2} observers) "
          f"through the detection eval CLI in PyTorchINT8 (the simulation's "
          f"eval forward): {len(preds)} test images at 800 px in "
          f"{time.perf_counter() - t0:.1f} s, COCO summary "
          f"{' '.join(f'{v:.4f}' for v in stats)}; kernels launched "
          f"{ {k: v for k, v in eval_launches.items() if v} }")
    check(stats.shape == (12,) and bool(np.isfinite(stats).all()),
          "COCO summary of the INT8 checkpoint")
    check(all(v == 0 for v in eval_launches.values())
          and all(v == (0, 0) for v in eval_ops.values()),
          f"INT8 detection eval launched {eval_launches}")


# segmentation (phase seg): prepare_synthetic.py's DLRSD layout, 5 texture
# classes at 80 px, resized to 224 px; 320 images: 224 train (3 steps of
# 2 x 32, the rest dropped), 32 val (one batch), 64 test (two batches);
# the FP16_32 and INT8 runs train on the first 128 (2 steps)
SEG_COUNT = 320
SEG_SHORT_TRAIN = 128
# the prediction and label PNGs the test CLI writes in the FP32 run
SEG_VISUALIZE = 4


def make_seg_dataset():
    """The synthetic DLRSD-layout dataset and its data config at 224 px
    (Resize of the val and test split, RandomResizedCrop of the train
    split), and a data config whose train split is the first
    :data:`SEG_SHORT_TRAIN` train images."""
    data = os.path.join(WORK, "seg_data")
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "segmentation",
                                      "prepare_synthetic.py"),
         "--out", data, "--count", str(SEG_COUNT), "--seed", "7"],
        check=True, capture_output=True,
    )
    with open(os.path.join(ROOT, "segmentation", "data_configs",
                           "data_config_synth.json")) as f:
        data_config = json.load(f)
    data_config["dataset_path"] = data
    data_config["transform_ops_train"]["RandomResizedCrop"] = 224
    data_config["transform_ops_val"]["Resize"] = 224
    with open(os.path.join(data, data_config["train_files"])) as f:
        lines = f.read().split()
    with open(os.path.join(data, "train_short_imagepaths.txt"), "w") as f:
        f.write("\n".join(lines[:SEG_SHORT_TRAIN]))
    short = dict(data_config, train_files="train_short_imagepaths.txt")
    return (data_config, write_json("seg_data_config.json", data_config),
            write_json("seg_short_data_config.json", short))


def seg_small_config(data_cfg, name, q_format="FP32"):
    """segmentation/train_configs/seg_small.json at its full width, in
    ``q_format``, one epoch from the seed (no pretrained backbone) at the
    config's peak LR, a checkpoint and a validation every 3 steps."""
    with open(os.path.join(ROOT, "segmentation", "train_configs",
                           "seg_small.json")) as f:
        config = json.load(f)
    config["data_config_path"] = data_cfg
    config["vit_config"]["q_format"] = q_format
    config["train_config"].update(
        output_directory=os.path.join(WORK, name), checkpoint_path="",
        epochs=1, warmup_epochs=0, pretrained_backbone=None,
        iters_per_checkpoint=3, iters_per_val=3)
    return config, write_json(f"{name}.json", config)


def run_seg_train(cfg, tag):
    """The segmentation train CLI on the card, its lines printed after
    ``tag``: (steps, losses, run directory, kernel launches, op launches,
    seconds)."""
    from myrtle_vision_tpu_torch.segmentation import train as train_cli

    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = train_cli.main(["-c", cfg, "--device", "cuda"])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("Iteration", "Epoch", "miou", "WARNING")):
            print(f"{tag}: {line.strip()}")
    losses = [float(v) for v in
              re.findall(r"Iteration \d+:\tloss=(\S+)\tacc=", text)]
    check(state.iteration == len(losses) > 0
          and all(math.isfinite(v) for v in losses),
          f"{tag}: {state.iteration} steps, losses {losses}")
    run_dir = text.split("output directory: ")[1].split("\n")[0]
    return state.iteration, losses, run_dir, launches, ops, took


def run_seg_test(config, ckpt, name, argv=()):
    """The segmentation test CLI on the card on ``ckpt``: (MIoU, its
    printed lines, kernel launches, op launches)."""
    from myrtle_vision_tpu_torch.segmentation import test as test_cli

    config["train_config"]["checkpoint_path"] = ckpt
    cfg = write_json(f"{name}.json", config)
    reset_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        miou = test_cli.main(["-c", cfg, "--device", "cuda", *argv])
    launches, ops = read_counts()
    return miou, out.getvalue().splitlines(), launches, ops, cfg


def seg_logits(model, loader, plain=False):
    """The eval forward's pixel logits of each test batch, real images
    only, kept on the card."""
    model.eval()
    out = []
    with torch.inference_mode():
        for batch in loader.epoch(0):
            n = int(batch.pop("_n_valid", len(batch["image"])))
            out.append(model(batch["image"], plain=plain)[:n].float())
    return out


def phase_seg(device, power):
    """DLRSD segmentation on seg_small.json at its full width (ViT-S/16:
    dim 384, depth 12, 6 heads, MLP 1536, 224 px = 197 tokens, local batch
    32, global 64) through the port's segmentation CLIs: FP32 (bf16
    compute) trains 3 steps through the fused K1-K4 chains and its last
    checkpoint goes through the test CLI (launches counted exactly, PNGs
    written) and, exported and imported back by the checkpoint CLIs, gives
    the same logits bit for bit; the eval logits and the first step kernel
    against plain; FP16_32 QAT (the qspec chains) and PyTorchINT8 one-pass
    QAT (PyTorch operations, no kernel) train 2 steps each and evaluate;
    then the timing line.  Returns the FP32 run's kernel launches."""
    from myrtle_vision_tpu_torch.classification import (
        export_checkpoint,
        import_checkpoint,
    )
    from myrtle_vision_tpu_torch.quantize import is_observer
    from myrtle_vision_tpu_torch.segmentation import test as test_cli
    from myrtle_vision_tpu_torch.segmentation import train as train_cli
    from myrtle_vision_tpu_torch.training.segmentation import (
        pixel_cross_entropy,
    )

    t_phase = time.perf_counter()
    data_config, data_cfg, short_cfg = make_seg_dataset()
    n_cls = data_config["number_of_classes"]
    config, cfg = seg_small_config(data_cfg, "seg_fp32")
    tc, vc = config["train_config"], config["vit_config"]
    depth = vc["depth"]
    print(f"seg: segmentation/train_configs/seg_small.json at full width "
          f"(ViT-S/16: dim {vc['embed_dim']}, depth {depth}, {vc['heads']} "
          f"heads, MLP {vc['mlp_dim']}, {vc['image_size']} px = 197 tokens, "
          f"local batch {tc['local_batch_size']}, global "
          f"{tc['global_batch_size']}); cut: {n_cls} classes for DLRSD's "
          f"17 (prepare_synthetic.py's textures, {SEG_COUNT} images of 80 "
          f"px resized to 224), no pretrained backbone, a few steps")

    # FP32 (bf16 compute): the train CLI through the fused chains
    steps, losses, run_dir, launches, ops, took = run_seg_train(cfg,
                                                                "seg")
    with contextlib.redirect_stdout(io.StringIO()):
        model, train_loader, val_loader, (micro, n_accum) = \
            train_cli.build_train(config, device)
    validations = len(range(0, steps, tc["iters_per_val"]))
    val_batches = len(val_loader)
    bwd = depth * n_accum * steps
    fwd = bwd + depth * validations * val_batches
    print(f"seg: FP32 train CLI on cuda, {steps} steps of {n_accum} x "
          f"{micro} images and {validations} validation of "
          f"{val_batches} batch in {took:.1f} s: op launches (forward, "
          f"backward) {ops}, expected ({fwd}, {bwd}) each; kernels "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(steps == 3, f"seg: {steps} steps, expected 3")
    for op in ("fused_attention_block", "fused_mlp_block"):
        check(ops[op] == (fwd, bwd), f"seg: {op} launches {ops[op]}")
    check(all(v == (0, 0) for k, v in ops.items()
              if k not in ("fused_attention_block", "fused_mlp_block")),
          f"seg: op launches {ops}")
    check(all(launches[k] > 0 for k in FP32_KERNELS),
          f"seg: a kernel never launched: {launches}")
    ckpts = sorted(os.listdir(run_dir))
    check(ckpts == ["vit_000000", f"vit_{steps:06}"], f"seg: {ckpts}")
    first_step_check(model, train_loader, os.path.join(run_dir, "vit_000000"),
                     n_accum, micro, losses[0], tag="seg",
                     criterion=pixel_cross_entropy)
    del model, train_loader, val_loader

    # the last checkpoint through the test CLI, PNGs written
    ckpt = os.path.join(run_dir, ckpts[-1])
    vis = os.path.join(WORK, "seg_vis")
    miou, lines, launches_eval, ops_eval, eval_cfg = run_seg_test(
        config, ckpt, "seg_fp32_eval",
        ["--visualize_dir", vis, "--visualize_n", str(SEG_VISUALIZE)])
    with open(os.path.join(data_config["dataset_path"],
                           data_config["test_files"])) as f:
        test_batches = len(f.read().split()) // micro
    expect = dict.fromkeys(launches_eval, 0)
    expect.update(layernorm_rows=2 * depth * test_batches,
                  gemm_bf16_epilogue=4 * depth * test_batches,
                  attention_core=depth * test_batches)
    pngs = sorted(os.listdir(vis))
    print(f"seg: {ckpts[-1]} through the test CLI: {lines[0]} "
          f"({' '.join(v.strip() for v in lines[1:])}), {len(pngs)} PNGs; "
          f"kernels {launches_eval} (expected {2 * depth}, {4 * depth}, "
          f"{depth} a batch of {test_batches})")
    check(launches_eval == expect, f"seg: eval launches {launches_eval}")
    check(ops_eval["fused_attention_block"] == (depth * test_batches, 0),
          f"seg: eval op launches {ops_eval}")
    check(pngs == sorted(f"{k}_{i}.png" for k in ("label", "pred")
                         for i in range(SEG_VISUALIZE)), f"seg: {pngs}")
    check(miou.total_area_union.sum() > 0
          and not np.isnan(miou.get_per_class_iou()).all(), "seg: mIoU")

    # the eval logits, kernel path against plain path, on the card
    with open(eval_cfg) as f:
        eval_config = json.load(f)
    model, loader, _ = test_cli.build_eval(eval_config, device)
    kernel = seg_logits(model, loader)
    plain = seg_logits(model, loader, plain=True)
    diff = max((k - p).abs().max().item() for k, p in zip(kernel, plain))
    top = max(p.abs().max().item() for p in plain)
    agree = (sum((k.argmax(-1) == p.argmax(-1)).sum().item()
                 for k, p in zip(kernel, plain))
             / sum(p[..., 0].numel() for p in plain))
    limit = LOGIT_BAR * max(1.0, top)
    print(f"seg: eval pixel logits {tuple(kernel[0].shape)} a batch, kernel "
          f"vs plain max_abs {diff:.6g} (bar {limit:.6g}), per-pixel argmax "
          f"agreement {agree:.6f} (bar {ARGMAX_BAR})")
    check(all(bool(torch.isfinite(k).all()) for k in kernel)
          and kernel[0].shape[1:] == (224, 224, n_cls), "seg: eval logits")
    check(diff <= limit and agree >= ARGMAX_BAR,
          "seg: kernel-path pixel logits disagree with the plain path")
    del plain, model

    # export, import back, the imported file through the eval forward
    pth = os.path.join(WORK, "seg_fp32_export.pth")
    imported = os.path.join(WORK, "seg_fp32_imported")
    with contextlib.redirect_stdout(io.StringIO()):
        export_checkpoint.main(["-c", eval_cfg, "--output", pth,
                                "--wrap_train_ckpt"])
        import_checkpoint.main(["-c", eval_cfg, "--torch_ckpt", pth,
                                "--output", imported])
    exported = torch.load(pth, weights_only=True)["model"]
    eval_config["train_config"]["checkpoint_path"] = imported
    model, loader, _ = test_cli.build_eval(eval_config, device)
    again = seg_logits(model, loader)
    same = all(torch.equal(a, b) for a, b in zip(kernel, again))
    print(f"seg: {ckpts[-1]} exported ({len(exported)} reference tensors, "
          f"{os.path.getsize(pth) / 2 ** 20:.1f} MiB) and imported back by "
          f"the checkpoint CLIs: eval logits bit for bit {same}")
    check(same, "seg: the imported checkpoint's logits differ")
    del kernel, again, model, loader

    # FP16_32 QAT and PyTorchINT8 one-pass QAT, 2 steps each, then eval
    for q_format in ("FP16_32", "PyTorchINT8"):
        tag = f"seg-{q_format}"
        qconfig, qcfg = seg_small_config(short_cfg, f"seg_{q_format}",
                                         q_format)
        with counting_plain_calls() as plain_calls:
            steps, losses, run_dir, launches, ops, took = run_seg_train(
                qcfg, tag)
        ckpt = os.path.join(run_dir, f"vit_{steps:06}")
        payload = torch.load(ckpt, weights_only=True)
        check(steps == 2 and payload["q_format"] == q_format,
              f"{tag}: {steps} steps, {payload['q_format']}")
        # two steps, then one validation (at iteration 0)
        fwd_expect = (depth * (n_accum * steps + val_batches),
                      depth * n_accum * steps)
        miou, lines, launches_eval, ops_eval, _ = run_seg_test(
            qconfig, ckpt, f"seg_{q_format}_eval")
        print(f"{tag}: train CLI on cuda, {steps} steps of {n_accum} x "
              f"{micro} images and a validation in {took:.1f} s: op "
              f"launches {ops}, plain-version calls {plain_calls['n']}, "
              f"kernels { {k: v for k, v in launches.items() if v} }; "
              f"vit_{steps:06} through the test CLI: {lines[0]}, op "
              f"launches {ops_eval}, kernels "
              f"{ {k: v for k, v in launches_eval.items() if v} }")
        check(miou.total_area_union.sum() > 0, f"{tag}: mIoU")
        if q_format == "FP16_32":
            for op in ("fused_attention_block", "fused_mlp_block"):
                check(ops[op] == fwd_expect,
                      f"{tag}: {op} launches {ops[op]}, expected "
                      f"{fwd_expect}")
            check(plain_calls["n"] == 0, f"{tag}: a plain version ran")
            check(all(launches[k] > 0 for k in FLOAT_KERNELS + QAT_KERNELS
                      + ("attention_core_f32", "colsum_rows")),
                  f"{tag}: a kernel never launched: {launches}")
            check(ops_eval["fused_attention_block"]
                  == (depth * test_batches, 0)
                  and launches_eval["fake_quant_rows"] > 0,
                  f"{tag}: eval launches {ops_eval}, {launches_eval}")
            with contextlib.redirect_stdout(io.StringIO()):
                model, train_loader, _, _ = train_cli.build_train(qconfig,
                                                                  device)
            first_step_check(model, train_loader,
                             os.path.join(run_dir, "vit_000000"), n_accum,
                             micro, losses[0], tag=tag,
                             criterion=pixel_cross_entropy)
            del model, train_loader
        else:
            # the JAX one-pass step runs the discrete calibrating Block:
            # no kernel of the port
            check(all(v == 0 for v in launches.values())
                  and all(v == 0 for v in launches_eval.values())
                  and all(v == (0, 0) for v in ops.values())
                  and all(v == (0, 0) for v in ops_eval.values()),
                  f"{tag}: launched {launches}, {ops}, {launches_eval}")
            observers = [float(t) for n, t in payload["model"].items()
                         if is_observer(n)]
            check(observers and all(math.isfinite(v) for v in observers),
                  f"{tag}: the checkpoint's observers")
    time_seg(device, power, data_config)
    print(f"seg: phase took {time.perf_counter() - t_phase:.1f} s")


def time_seg(device, power, data_config):
    """CUDA-event times of seg_small's FP32 train step (2 micro-batches of
    32, forward, backward, AdamW), its eval forward at B=32 and the
    FP16_32 QAT step, random weights and images, with device profiles
    (idle share) of the FP32 step and forward."""
    from myrtle_vision_tpu_torch.models.vit import ViT
    from myrtle_vision_tpu_torch.training.classification import (
        make_predict_fn,
    )
    from myrtle_vision_tpu_torch.training.optim import create_optimizer
    from myrtle_vision_tpu_torch.training.segmentation import make_loss_fn
    from myrtle_vision_tpu_torch.training.trainer import (
        TrainState,
        make_train_step,
    )

    with open(os.path.join(ROOT, "segmentation", "train_configs",
                           "seg_small.json")) as f:
        tc = json.load(f)["train_config"]
    n_cls = data_config["number_of_classes"]
    g = torch.Generator(device=device).manual_seed(0)
    batch = {"image": torch.randn(2, 32, 224, 224, 3, device=device,
                                  generator=g),
             "label": torch.randint(0, n_cls, (2, 32, 224, 224),
                                    device=device, generator=g,
                                    dtype=torch.int32)}
    ms = {}
    for q_format in ("FP32", "FP16_32"):
        model = ViT("segmentation", 224, 16, n_cls, 384, 12, 6, 1536,
                    q_format=q_format, device=device)
        state = TrainState(model, create_optimizer(tc, model))
        step = make_train_step(make_loss_fn(model), 2)
        ms[q_format] = cuda_ms(lambda: step(state, batch, tc["lr"]),
                               iters=5, warmup=2)
        if q_format == "FP32":
            profile = device_profile(lambda: step(state, batch, tc["lr"]), {
                "gemm_bf16_epilogue": ("gemm_wgmma",),
                "attention_core": ("attention_core_kernel",),
                "attention_core_bwd": ("attention_core_bwd",),
                "LayerNorm, forward and backward": ("layernorm_rows",),
                "colsum_rows": ("colsum",)})
            predict = make_predict_fn(model)
            ms["forward"] = cuda_ms(lambda: predict(batch["image"][0]),
                                    iters=10, warmup=2)
            forward_profile = device_profile(
                lambda: predict(batch["image"][0]), {
                    "gemm_bf16_epilogue": ("gemm_wgmma",),
                    "attention_core": ("attention_core_kernel",),
                    "LayerNorm": ("layernorm_rows",)})
        del model, state, step
    print(f"timing: seg ViT-S/16 segmentation (seg_small.json, 224 px, "
          f"{n_cls} classes): FP32 train step 2 x 32 (forward, backward, "
          f"AdamW) {ms['FP32']:.3f} ms = {64 / ms['FP32'] * 1e3:.1f} img/s, "
          f"eval forward B=32 {ms['forward']:.3f} ms = "
          f"{32 / ms['forward'] * 1e3:.1f} img/s, FP16_32 QAT train step 2 "
          f"x 32 {ms['FP16_32']:.3f} ms = {64 / ms['FP16_32'] * 1e3:.1f} "
          f"img/s [{power}]")
    print(f"timing: seg FP32 train step profile (2 x 32, one step): "
          f"{profile} [{power}]")
    print(f"timing: seg FP32 eval forward profile (B=32, one forward): "
          f"{forward_profile} [{power}]")


# the student's train split in the distill phase: 3 steps of 2 x 32
DISTILL_TRAIN = 192
# the quantized students of phase distill (2 steps of 2 x 32 each)
DISTILL_FORMATS = ("FP16_32", "PyTorchINT8")
DISTILL_FORMAT_TRAIN = 128
# the teacher on the card against the same teacher on the CPU, fp32
# without TF32 on both: 1e-4 of the largest logit (TF32 would be ~1e-3)
TEACHER_BAR = 1e-4


def deit_small_config(data_cfg, teacher_pth):
    """classification/train_configs/deit_small.json at its full width
    (dim 384, depth 12, 6 heads, MLP 1536, 224 px: 197 tokens and the
    distillation token; local batch 32, global 64), the distiller's
    teacher ``teacher_pth``, one epoch from the seed (no pretrained
    backbone) at the config's peak LR, a checkpoint and a validation every
    3 steps."""
    with open(os.path.join(ROOT, "classification", "train_configs",
                           "deit_small.json")) as f:
        config = json.load(f)
    config["data_config_path"] = data_cfg
    config["distiller_config"]["teacher_weights_path"] = teacher_pth
    config["train_config"].update(
        output_directory=os.path.join(WORK, "distill"), checkpoint_path="",
        epochs=1, warmup_epochs=0, pretrained_backbone=None,
        iters_per_checkpoint=3, iters_per_val=3)
    return config


@contextlib.contextmanager
def recording_tokens():
    """Records, in the yielded list, the token count of every call of the
    fused attention op that the ViT's blocks make while it is open."""
    from myrtle_vision_tpu_torch.models import vit

    seen = []
    op = vit.fused_attention_block

    def record(x, *args, **kwargs):
        seen.append(x.shape[1])
        return op(x, *args, **kwargs)

    vit.fused_attention_block = record
    try:
        yield seen
    finally:
        vit.fused_attention_block = op


def phase_distill(device, power, data_config, data_cfg):
    """DeiT distillation with a CNN teacher on deit_small.json at its full
    width, through the port's CLIs on the card: finetune_cnn writes a
    ResNet-50 teacher (He-init, one epoch of the synthetic train split at
    224 px, batch 32); test_cnn evaluates it, and the teacher on the card
    is held against the same teacher on the CPU; the train CLI distils the
    ViT-S/16 student for 3 steps of 2 x 32 through the fused K1-K4 chains
    at 198 tokens (launches counted, the token count of every call
    recorded), the first step kernel vs plain; the eval CLI reads the last
    checkpoint's student, the export CLI writes it, and the eval CLI gives
    the same logits from the exported file; then the timing line."""
    from myrtle_vision_tpu_torch.classification import (
        export_checkpoint,
        finetune_cnn,
        test_cnn,
    )
    from myrtle_vision_tpu_torch.classification import test as eval_cli
    from myrtle_vision_tpu_torch.classification import train as train_cli
    from myrtle_vision_tpu_torch.models.resnet import make_teacher_fn

    t_phase = time.perf_counter()
    data = data_config["dataset_path"]
    with open(os.path.join(data, data_config["train_files"])) as f:
        lines = f.read().split()
    teacher_pth = os.path.join(WORK, "resnet50_synth_teacher.pth")
    out = io.StringIO()
    t0 = time.perf_counter()
    reset_counts()
    with contextlib.redirect_stdout(out):
        sd, history = finetune_cnn.main([
            "--model", "resnet50", "--data_config", data_cfg, "--epochs",
            "1", "--batch_size", "32", "--lr", "1e-3", "--output",
            teacher_pth, "--device", "cuda"])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    bns = [k for k in sd if k.endswith("running_mean")]
    print(f"distill: finetune_cnn ResNet-50 on cuda (He-init, one epoch of "
          f"{len(lines)} images at 224 px, batch "
          f"32) in {took:.1f} s: {out.getvalue().splitlines()[0]}; "
          f"{len(sd)} tensors, {len(bns)} batch norms each with "
          f"num_batches_tracked, {os.path.getsize(teacher_pth) / 2 ** 20:.1f}"
          f" MiB")
    check(math.isfinite(history[0][0]), f"distill: finetune loss {history}")
    check(all(k[: -len("running_mean")] + "num_batches_tracked" in sd
              for k in bns) and len(bns) == 53, "distill: the teacher's BNs")
    check(all(v == 0 for v in launches.values())
          and all(v == (0, 0) for v in ops.values()),
          f"distill: finetune launched a port kernel: {launches}")

    with contextlib.redirect_stdout(io.StringIO()):
        gts, preds, logits = test_cnn.main([
            "--model", "resnet50", "--cnn_weights", teacher_pth,
            "--data_config", data_cfg, "--device", "cuda"])
    check(logits.shape == (len(gts), data_config["number_of_classes"])
          and bool(torch.isfinite(logits).all()), "distill: test_cnn")
    images = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (32, 224, 224, 3)).astype(np.float32))
    card = make_teacher_fn(teacher_pth, device=device)(images.to(device))
    ref = make_teacher_fn(teacher_pth)(images)
    rel = ((card.cpu() - ref).abs().max() / ref.abs().max()).item()
    print(f"distill: test_cnn on cuda: {len(gts)} test images, accuracy "
          f"{float(np.mean(gts == preds)):.4f}; the teacher on the card vs "
          f"on the CPU (fp32, TF32 off), 32 images at 224 px: max abs "
          f"{(card.cpu() - ref).abs().max().item():.4g}, {rel:.4g} of the "
          f"largest logit (bar {TEACHER_BAR:g})")
    check(rel <= TEACHER_BAR, "distill: the teacher on the card disagrees "
          "with the CPU")

    # the student: deit_small.json at full width, 3 steps of 2 x 32
    with open(os.path.join(data, "train_distill_imagepaths.txt"), "w") as f:
        f.write("\n".join(lines[:DISTILL_TRAIN]))
    short_cfg = write_json("distill_data_config.json", dict(
        data_config, train_files="train_distill_imagepaths.txt"))
    config = deit_small_config(short_cfg, teacher_pth)
    cfg = write_json("deit_small_distill.json", config)
    tc, vc = config["train_config"], config["vit_config"]
    dc = config["distiller_config"]
    depth = vc["depth"]
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with recording_tokens() as tokens, contextlib.redirect_stdout(out):
        state = train_cli.main(["-c", cfg, "--device", "cuda"])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("Iteration", "Epoch", "WARNING")):
            print(f"distill: {line.strip()}")
    steps = state.iteration
    losses = [float(v) for v in
              re.findall(r"Iteration \d+:\tloss=(\S+)\tacc=", text)]
    with contextlib.redirect_stdout(io.StringIO()):
        model, train_loader, val_loader, (micro, n_accum) = \
            train_cli.build_train(config, device)
    val_batches = len(val_loader)
    validations = len(range(0, steps, tc["iters_per_val"]))
    bwd = depth * n_accum * steps
    # a validation batch runs the student twice: the plain ViT for the
    # accuracy (197 tokens), the wrapper for the distillation loss (198)
    fwd = bwd + 2 * depth * validations * val_batches
    n198 = bwd + depth * validations * val_batches
    counted = {n: tokens.count(n) for n in sorted(set(tokens))}
    print(f"distill: deit_small.json at full width (dim {vc['embed_dim']}, "
          f"depth {depth}, {vc['heads']} heads, MLP {vc['mlp_dim']}, "
          f"{vc['image_size']} px: 197 tokens + the distillation token, "
          f"local batch {tc['local_batch_size']}, global "
          f"{tc['global_batch_size']}, T {dc['temperature']}, alpha "
          f"{dc['alpha']}); cut: 10 synthetic "
          f"classes for RESISC45's 45, {DISTILL_TRAIN} train images, no "
          f"pretrained backbone, a teacher of one epoch")
    print(f"distill: train CLI on cuda, {steps} steps of {n_accum} x {micro} "
          f"images and {validations} validation of {val_batches} batch in "
          f"{took:.1f} s: op launches (forward, backward) {ops}, expected "
          f"({fwd}, {bwd}) each; attention calls by token count {counted}, "
          f"expected {{197: {fwd - n198}, 198: {n198}}}; kernels "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(steps == DISTILL_TRAIN // tc["global_batch_size"] == 3
          and len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"distill: {steps} steps, losses {losses}")
    for op in ("fused_attention_block", "fused_mlp_block"):
        check(ops[op] == (fwd, bwd), f"distill: {op} launches {ops[op]}")
    check(all(v == (0, 0) for k, v in ops.items()
              if k not in ("fused_attention_block", "fused_mlp_block")),
          f"distill: op launches {ops}")
    check(counted == {197: fwd - n198, 198: n198},
          f"distill: token counts {counted}")
    check(all(launches[k] > 0 for k in FP32_KERNELS),
          f"distill: a kernel never launched: {launches}")
    run_dir = text.split("output directory: ")[1].split("\n")[0]
    ckpts = sorted(os.listdir(run_dir))
    check(ckpts == ["vit_000000", f"vit_{steps:06}"], f"distill: {ckpts}")
    first_step_check(model, train_loader, os.path.join(run_dir, "vit_000000"),
                     n_accum, micro, losses[0], tag="distill",
                     teacher=train_cli.build_teacher(config, device))
    del model, train_loader, val_loader

    # the last checkpoint's student through the eval CLI; exported, and
    # the exported file through the eval CLI again
    ckpt = os.path.join(run_dir, ckpts[-1])
    wrapper_tensors = len(torch.load(ckpt, weights_only=True)["model"])
    config["train_config"]["checkpoint_path"] = ckpt
    eval_cfg = write_json("deit_small_eval.json", config)
    with open(os.path.join(data, data_config["test_files"])) as f:
        test_batches = len(f.read().split()) // micro
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        gts, preds, logits = eval_cli.main(["-c", eval_cfg, "--device",
                                            "cuda"])
    _, ops_eval = read_counts()
    pth = os.path.join(WORK, "deit_small_student.pth")
    with contextlib.redirect_stdout(io.StringIO()):
        export_checkpoint.main(["-c", eval_cfg, "--output", pth])
    exported = torch.load(pth, weights_only=True)
    config["train_config"]["checkpoint_path"] = pth
    with contextlib.redirect_stdout(io.StringIO()):
        _, _, again = eval_cli.main(["-c", write_json(
            "deit_small_exported_eval.json", config), "--device", "cuda"])
    same = torch.equal(logits, again)
    print(f"distill: {ckpts[-1]} (the DistillWrapper's {wrapper_tensors} "
          f"tensors) through the eval CLI: {len(gts)} test images, "
          f"accuracy {float(np.mean(gts == preds)):.4f}, op launches "
          f"{ops_eval}; exported ({len(exported)} student tensors, "
          f"{os.path.getsize(pth) / 2 ** 20:.1f} MiB): eval logits bit for "
          f"bit {same}")
    check(logits.shape == (test_batches * micro,
                           data_config["number_of_classes"])
          and bool(torch.isfinite(logits).all()), "distill: eval")
    check(ops_eval["fused_attention_block"] == (depth * test_batches, 0),
          f"distill: eval launches {ops_eval}")
    check(not any(k.startswith(("student.", "distill"))
                  for k in exported), "distill: the export holds more than "
          "the student")
    check(same, "distill: the exported student's logits differ")
    for q_format in DISTILL_FORMATS:
        distill_student(device, data_config, lines, teacher_pth, q_format)
    time_distill(device, power, config, data_config)
    print(f"distill: phase took {time.perf_counter() - t_phase:.1f} s")


def distill_student(device, data_config, lines, teacher_pth, q_format):
    """deit_small.json's student in a quantized ``q_format`` through the
    port's CLIs on the card: the train CLI distils it for 2 steps of 2 x
    32 from the seed (FP16_32: its QAT simulation, the fused K1-K4
    ``qspec`` chains at 198 tokens forward and backward and K11 at the
    sites outside them, launches and token counts; PyTorchINT8: the
    one-pass step, the calibrating forward differentiated, PyTorch
    operations as in the JAX package, no kernel of the port), no plain
    call; the first step kernel vs plain (the FP32 bars, as phases qat
    and qat-int8 hold their first steps); the eval CLI reads the last
    checkpoint's student (the INT8 simulation's eval forward), and the
    export CLI writes its parameters under the reference names (FP16_32:
    the QAT-prepared ``.1`` names), bit for bit, no observer."""
    from myrtle_vision_tpu_torch.classification import (
        export_checkpoint,
    )
    from myrtle_vision_tpu_torch.classification import test as eval_cli
    from myrtle_vision_tpu_torch.classification import train as train_cli
    from myrtle_vision_tpu_torch.utils.convert import (
        load_reference_checkpoint,
    )
    from myrtle_vision_tpu_torch.utils.export import export_state_dict

    tag = f"distill-{q_format}"
    int8 = q_format == "PyTorchINT8"
    t0 = time.perf_counter()
    data = data_config["dataset_path"]
    name = f"train_distill_{q_format}_imagepaths.txt"
    with open(os.path.join(data, name), "w") as f:
        f.write("\n".join(lines[:DISTILL_FORMAT_TRAIN]))
    config = deit_small_config(write_json(
        f"distill_{q_format}_data_config.json",
        dict(data_config, train_files=name)), teacher_pth)
    config["vit_config"]["q_format"] = q_format
    tc = config["train_config"]
    tc["output_directory"] = os.path.join(WORK, f"distill_{q_format}")
    cfg = write_json(f"deit_small_{q_format}.json", config)
    depth = config["vit_config"]["depth"]
    reset_counts()
    out = io.StringIO()
    with counting_plain_calls() as plain_calls, recording_tokens() as \
            tokens, contextlib.redirect_stdout(out):
        state = train_cli.main(["-c", cfg, "--device", "cuda"])
    launches, ops = read_counts()
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("Iteration", "Epoch", "WARNING")):
            print(f"{tag}: {line.strip()}")
    steps = state.iteration
    losses = [float(v) for v in
              re.findall(r"Iteration \d+:\tloss=(\S+)\tacc=", text)]
    with contextlib.redirect_stdout(io.StringIO()):
        model, train_loader, val_loader, (micro, n_accum) = \
            train_cli.build_train(config, device)
    validations = len(range(0, steps, tc["iters_per_val"]))
    val_batches = len(val_loader)
    bwd = 0 if int8 else depth * n_accum * steps
    fwd = 0 if int8 else bwd + 2 * depth * validations * val_batches
    n198 = 0 if int8 else bwd + depth * validations * val_batches
    counted = {n: tokens.count(n) for n in sorted(set(tokens))}
    want = {} if int8 else {197: fwd - n198, 198: n198}
    kernels = (FLOAT_KERNELS + ("attention_core_f32",) + QAT_KERNELS
               + ("colsum_rows",))
    print(f"{tag}: deit_small.json's student in {q_format} at full width, "
          f"train CLI on cuda, {steps} steps of {n_accum} x {micro} images "
          f"and {validations} validation of {val_batches} batches in "
          f"{time.perf_counter() - t0:.1f} s: op launches (forward, "
          f"backward) {ops}, expected ({fwd}, {bwd}) of the two fused ops; "
          f"attention calls by token count {counted}, expected {want}; "
          f"plain-version calls {plain_calls['n']}; kernels "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(steps == DISTILL_FORMAT_TRAIN // tc["global_batch_size"] == 2
          and len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"{tag}: {steps} steps, losses {losses}")
    for op, count in ops.items():
        check(count == ((fwd, bwd) if op in ("fused_attention_block",
                                             "fused_mlp_block") else (0, 0)),
              f"{tag}: {op} launches {count}")
    check(counted == want, f"{tag}: token counts {counted}")
    check(plain_calls["n"] == 0, f"{tag}: a plain version ran")
    check(all(v == 0 for v in launches.values()) if int8
          else all(launches[k] > 0 for k in kernels),
          f"{tag}: kernel launches {launches}")
    run_dir = text.split("output directory: ")[1].split("\n")[0]
    ckpts = sorted(os.listdir(run_dir))
    check(ckpts == ["vit_000000", f"vit_{steps:06}"], f"{tag}: {ckpts}")
    payload = torch.load(os.path.join(run_dir, ckpts[-1]), weights_only=True)
    observers = [k for k in payload["model"] if k.endswith((".min", ".max"))]
    sites = [k for k in observers if k.startswith((
        "student.quant_distill_token.", "student.distill_token_cat."))]
    check(len(sites) == (4 if int8 else 0)
          and (len(observers) == 2 * (6 + 3 + 10 * depth) + 4 if int8
               else not observers), f"{tag}: observers {len(observers)}")
    first_step_check(model, train_loader, os.path.join(run_dir, "vit_000000"),
                     n_accum, micro, losses[0], tag=tag,
                     teacher=train_cli.build_teacher(config, device))
    del model, train_loader, val_loader

    ckpt = os.path.join(run_dir, ckpts[-1])
    config["train_config"]["checkpoint_path"] = ckpt
    eval_cfg = write_json(f"deit_small_{q_format}_eval.json", config)
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        gts, preds, logits = eval_cli.main(["-c", eval_cfg, "--device",
                                            "cuda"])
    _, ops_eval = read_counts()
    pth = os.path.join(WORK, f"deit_small_{q_format}_student.pth")
    with contextlib.redirect_stdout(io.StringIO()):
        export_checkpoint.main(["-c", eval_cfg, "--output", pth])
    exported = torch.load(pth, weights_only=True)
    want = export_state_dict(load_reference_checkpoint(ckpt),
                             "classification", qat_wrapped=not int8)
    same = set(exported) == set(want) and all(
        torch.equal(exported[k], t) for k, t in want.items())
    print(f"{tag}: {ckpts[-1]}'s student through the eval CLI: {len(gts)} "
          f"test images, accuracy {float(np.mean(gts == preds)):.4f}, op "
          f"launches {ops_eval}; the export CLI's file ({len(exported)} "
          f"tensors, {'plain' if int8 else 'QAT-prepared .1'} names, no "
          f"observer) holds the student's parameters bit for bit: {same}")
    check(bool(torch.isfinite(logits).all()) and len(gts) > 0,
          f"{tag}: eval")
    check(ops_eval["fused_attention_block"] == (
        (0, 0) if int8 else (depth * math.ceil(len(gts) / micro), 0)),
        f"{tag}: eval launches {ops_eval}")
    check(same, f"{tag}: the exported student differs")
    print(f"{tag}: took {time.perf_counter() - t0:.1f} s")


def time_distill(device, power, config, data_config, rounds=3):
    """CUDA-event times of deit_small's distilled FP32 train step (2
    micro-batches of 32: the teacher's forward, the student's forward and
    backward, AdamW), random weights and images, the student, its wrapper
    and the ResNet-50 teacher built from ``config`` as the train CLI
    builds them; the step and the teacher alone on the same two
    micro-batches in ``rounds`` alternating rounds (each round's figures
    and their medians), and a device profile of one step (idle share)."""
    from myrtle_vision_tpu_torch.classification import train as train_cli
    from myrtle_vision_tpu_torch.training.classification import make_loss_fn
    from myrtle_vision_tpu_torch.training.optim import create_optimizer
    from myrtle_vision_tpu_torch.training.trainer import (
        TrainState,
        make_train_step,
    )

    tc = config["train_config"]
    n_cls = data_config["number_of_classes"]
    g = torch.Generator(device=device).manual_seed(0)
    batch = {"image": torch.randn(2, 32, 224, 224, 3, device=device,
                                  generator=g),
             "label": torch.randint(0, n_cls, (2, 32), device=device,
                                    generator=g, dtype=torch.int32)}
    vit, model = train_cli.build_models(config, data_config, device,
                                        torch.Generator().manual_seed(0))
    teacher = train_cli.build_teacher(config, device)
    state = TrainState(model, create_optimizer(tc, model))
    step = make_train_step(make_loss_fn(vit, model, teacher), 2)
    step_ms, teacher_ms = [], []
    for _ in range(rounds):
        step_ms.append(cuda_ms(lambda: step(state, batch, tc["lr"]),
                               iters=5, warmup=2))
        teacher_ms.append(cuda_ms(lambda: [teacher(batch["image"][i])
                                           for i in range(2)],
                                  iters=5, warmup=2))
    step_med = float(np.median(step_ms))
    teacher_med = float(np.median(teacher_ms))
    profile = device_profile(lambda: step(state, batch, tc["lr"]), {
        "gemm_bf16_epilogue": ("gemm_wgmma",),
        "attention_core": ("attention_core_kernel",),
        "attention_core_bwd": ("attention_core_bwd",),
        "LayerNorm, forward and backward": ("layernorm_rows",),
        "colsum_rows": ("colsum",),
        "teacher convolutions (cuDNN)": ("fprop", "conv", "cudnn",
                                         "winograd", "implicit_gemm")})
    rounds_text = ", ".join(f"{a:.3f} / {b:.3f}"
                            for a, b in zip(step_ms, teacher_ms))
    print(f"timing: distill deit_small.json (ViT-S/16 student, 198 tokens, "
          f"ResNet-50 teacher, fp32 convolutions, {n_cls} classes): FP32 "
          f"distilled train step 2 x 32 (the teacher's forward, the "
          f"student's forward and backward, AdamW) median of {rounds} "
          f"rounds {step_med:.3f} ms = {64 / step_med * 1e3:.1f} img/s; the "
          f"teacher alone on the same 2 x 32 images {teacher_med:.3f} ms = "
          f"{teacher_med / step_med:.4f} of the step; rounds (step / "
          f"teacher ms) {rounds_text} [{power}]")
    print(f"timing: distill step profile (2 x 32, one step): {profile} "
          f"[{power}]")


def paired_ms(kernel, plain, iters=20, warmup=3):
    """plain, kernel, kernel, plain; the mean of each pair."""
    p1, k1, k2, p2 = (cuda_ms(f, iters, warmup)
                      for f in (plain, kernel, kernel, plain))
    return (k1 + k2) / 2, (p1 + p2) / 2


def time_case(totals, name, kernel, plain, count, c, power, tag):
    """Kernel and plain ms of one case (paired), its yardstick's ms, its
    bound; added, times ``count``, to its kernel's totals; returns
    (bound ms, yardstick ms or None, what bounds it).  The line adds the
    kernel's and the yardstick's device time by the profiler, kernel by
    kernel (a two-pass column sum's passes apart): for a call as small as
    a column sum, CUDA events around back-to-back calls time the
    wrapper's host cost."""
    k_ms, p_ms = paired_ms(kernel, plain)
    lib_ms = None if c["library"] is None else cuda_ms(c["library"])
    b_ms, by = bound(c)
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    # the tensor-core products' achieved rate, kernel and library
    rate = ""
    if c["peak"] in ("bf16", "int8"):
        unit = "TFLOP/s" if c["peak"] == "bf16" else "TOP/s"
        rate = f", kernel {c['ops'] / (k_ms * 1e9):.1f} {unit}" + (
            "" if lib_ms is None
            else f", library {c['ops'] / (lib_ms * 1e9):.1f} {unit}")
    dev_ms, by_kernel, miss = kernel_device_ms(kernel)
    device = (f", device not measured ({miss})"
              if dev_ms is None
              else f", device {dev_ms:.4f} ms (" + "; ".join(
                  f"{k} {v:.4f}" for k, v in sorted(by_kernel.items())) + ")")
    if c["library"] is not None:
        lib_dev, _, miss = kernel_device_ms(c["library"])
        device += (f", library device not measured ({miss})"
                   if lib_dev is None
                   else f", library device {lib_dev:.4f} ms")
    print(f"timing: {name} {tag} kernel {k_ms:.4f} ms plain {p_ms:.4f} ms, "
          f"library {lib}, bound {b_ms:.4f} ms ({by}: {c['bytes']} bytes, "
          f"{c['ops']} {c['peak']} ops){rate}{device}, {count} per block "
          f"[{power}]")
    acc = totals.setdefault(name.split("[")[0], {
        "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
        "device_ms": 0.0, "by": {"bytes": 0.0, "operations": 0.0}})
    acc["ms"] += count * k_ms
    # every case apart, also those outside the block (count 0)
    acc.setdefault("cases", {})[name] = {
        "shape": tag, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": by, "library_ms": lib_ms, "device_ms": dev_ms}
    # a case without a kernel record leaves its kernel's device sum unknown
    if count and (dev_ms is None or acc["device_ms"] is None):
        acc["device_ms"] = None
    elif count:
        acc["device_ms"] += count * dev_ms
    acc["plain_ms"] += count * p_ms
    acc["bound_ms"] += count * b_ms
    acc["by"][by] += count * b_ms
    # a case outside the block (count 0) leaves the yardstick sum alone
    if count and (lib_ms is None or acc["library_ms"] is None):
        acc["library_ms"] = None
    elif count:
        acc["library_ms"] += count * lib_ms
    return b_ms, lib_ms, by, k_ms, dev_ms


def f32x3_block_line(forward, backward, power, tag):
    """One line of gemm_f32x3_epilogue per ViT-S/16 block: the converted
    forward's four products (``forward``, the kernels line's totals)
    beside the QAT step's backward products (``backward``: {case name:
    time_case's result}), the weight gradients and the mul_aux product
    (dh and db1) apart, each with the profiler's device time."""
    def part(names):
        ms = sum(backward[n][3] for n in names)
        devs = [backward[n][4] for n in names]
        dev = "not measured" if None in devs else f"{sum(devs):.4f} ms"
        return f"{ms:.4f} ms (device {dev})"

    grads = [n for n in backward if "A^T]" in n]
    aux = [n for n in backward if "colsum]" in n]
    rest = [n for n in backward if n not in grads + aux]
    dev = ("not measured" if forward["device_ms"] is None
           else f"{forward['device_ms']:.4f} ms")
    print(f"timing: gemm_f32x3_epilogue {tag} per block: converted FP16_32 "
          f"forward {forward['ms']:.4f} ms (device {dev}); the FP16_32 QAT "
          f"step's backward products {part(list(backward))}: weight "
          f"gradients {part(grads)}, mul_aux {part(aux)}, the rest "
          f"{part(rest)} [{power}]")


def time_chain(cases, name, kernel, plain, power, tag):
    """A block-half chain: paired kernel and plain ms, the profiler's
    device time, and for the TPU kernel it replaces, the kernel launches
    of one call and the sums of its cases' bounds and yardsticks.  Returns
    {ms, plain_ms, bound_ms, bound_by, library_ms, device_ms} (bound_ms,
    bound_by and library_ms None where no TPU kernel names the chain)."""
    k_ms, p_ms = paired_ms(kernel, plain)
    reset_counts()
    kernel()
    launches = {k: v for k, v in read_counts()[0].items() if v}
    dev_ms, _, miss = kernel_device_ms(kernel)
    device = (f"device not measured ({miss})" if dev_ms is None
              else f"device {dev_ms:.4f} ms")
    line = (f"timing: {name} {tag} kernel chain {k_ms:.4f} ms ({device}) "
            f"plain {p_ms:.4f} ms [{power}]")
    out = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": None, "bound_by": None,
           "library_ms": None, "device_ms": dev_ms}
    for tpu, (chain, parts) in TPU_CHAINS.items():
        if chain == name:
            b_ms = sum(cases[p][0] for p in parts)
            libs = [cases[p][1] for p in parts if cases[p][1] is not None]
            missing = [p for p in parts if cases[p][1] is None]
            by = {"bytes": 0.0, "operations": 0.0}
            for p in parts:
                by[cases[p][2]] += cases[p][0]
            out.update(bound_ms=b_ms, bound_by=max(by, key=by.get),
                       library_ms=sum(libs))
            line += (f"; {tpu}: launches {launches}, bound {b_ms:.4f} ms, "
                     f"yardsticks {sum(libs):.4f} ms"
                     + (f" (none for {', '.join(missing)})" if missing
                        else ""))
    print(line)
    return out


def phase_timing(device, power, int8_ckpt, int8_kwargs, float_ckpt,
                 float_kwargs, int8_384_ckpt, int8_384_kwargs):
    """Per kernel: {ms, plain_ms, bound_ms, by, library_ms}, each the sum
    over the kernel's launches in one ViT-S/16 block at batch 256: a train
    step (forward with the saved statistics, backward) for the FP32
    kernels, a converted forward for the INT8 and the float (FP16_32)
    ones."""
    from myrtle_vision_tpu_torch.models.vit import ViT
    from myrtle_vision_tpu_torch.ops import _kernels as K
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
    # the process's first profiler session can come back without kernel
    # records, which left the first profiled case unmeasured: one session
    # first, and every session here, none before (sessions opened early in
    # the script were seen to drop records of later ones)
    kernel_device_ms(lambda: torch.ones(1, device=device).add_(1))
    totals["probes"] = probe_device_ms(device)
    xi, ai, mi, ci = int8_block_inputs(b, N, seed=257, device=device)
    for name, kernel, plain, _, count, c in int8_kernel_cases(xi, ai, mi, ci):
        cases[name] = time_case(totals, name, kernel, plain, count, c, power,
                                tag + " (converted forward)")
    for name, kernel, plain, _ in int8_op_cases(xi, ai, mi, ci):
        time_chain(cases, name, kernel, plain, power, tag)
    del xi, ai, mi, ci
    qspec = FLOAT_QSPECS["FP16_32"]
    xf, af, mf = float_block_inputs(b, N, seed=258, device=device,
                                    qspec=qspec)
    for name, kernel, plain, _, count, c in (
            float_kernel_cases(xf, af, mf, qspec)
            + fake_quant_block_cases(af, mf, qspec)):
        cases[name] = time_case(totals, name, kernel, plain, count, c, power,
                                tag + " (converted FP16_32 forward)")
    for name, kernel, plain in float_op_cases(xf, af, mf, qspec):
        time_chain(cases, name, kernel, plain, power, tag)
    # the QAT step's backward kernels and chains (FP16_32); only the two
    # kernels that run nowhere else enter the kernels' totals
    do_f = seeded(np.random.RandomState(260), (b, N, C), 1.0, device)
    qat_totals, qat_f32x3 = {}, {}
    for name, kernel, plain, _, count, c, _ in qat_kernel_cases(
            xf, af, mf, do_f, qspec):
        cases[name] = time_case(qat_totals, name, kernel, plain, count, c,
                                power, tag + " (FP16_32 QAT step)")
        if name.startswith("gemm_f32x3_epilogue["):
            qat_f32x3[name] = cases[name]
    for key in QAT_KERNELS:
        totals[key] = qat_totals[key]
    # the fp32 core's true divide priced: the same call with p = e * (1 /
    # rowsum), a variant that no path runs
    qkv_r = seeded(np.random.RandomState(263), (b, N, 3 * C), 1.0, device)
    div_ms, mul_ms = paired_ms(
        lambda: K.attention_core_snap_cuda(qkv_r, HEADS, SCALE, qspec,
                                           stats=True),
        lambda: K.attention_core_f32_recip_probe_cuda(qkv_r, HEADS, SCALE,
                                                      qspec))
    print(f"timing: attention_core_f32[snap,stats] {tag} (FP16_32 QAT "
          f"step): true divide {div_ms:.4f} ms, the variant that multiplies "
          f"by the reciprocal rowsum {mul_ms:.4f} ms, the divide's cost "
          f"{div_ms - mul_ms:.4f} ms [{power}]")
    del qkv_r
    f32x3_block_line(totals["gemm_f32x3_epilogue"], qat_f32x3, power, tag)
    for name, kernel, plain, _ in qat_op_cases(xf, af, mf, do_f, qspec):
        time_chain(cases, name, kernel, plain, power, tag)
    del xf, af, mf, do_f
    # the INT8 QAT chains (K1-K4 int8): the qspec chains' kernels at the
    # same shapes, so the cases' bounds and yardsticks above
    xq, aq, mq, sq = qat_int8_block_inputs(b, N, seed=261, device=device)
    do_q = seeded(np.random.RandomState(262), (b, N, C), 1.0, device)
    for name, kernel, plain, _ in qat_int8_op_cases(xq, aq, mq, do_q, sq):
        timed = time_chain(cases, name, kernel, plain, power,
                           tag + " (INT8 QAT step)")
        for tpu, (chain, _) in TPU_CHAINS.items():
            if chain == name:
                totals[tpu] = timed
    del xq, aq, mq, sq, do_q
    # K11 at the patch embedding's pre_linear site, once a forward
    xe = seeded(np.random.RandomState(259), (b, N - 1, 768), 1.0, device)
    time_case(totals, "fake_quant_rows[patch embedding act_in]",
              lambda: K.fake_quant_rows_cuda(xe, "float", 5, 10),
              lambda: K.fake_quant_rows_plain(xe, "float", 5, 10), 0,
              cost(2 * nbytes(xe), 10 * xe.numel(), "fp32",
                   lambda: xe.clamp(-65504, 65504).half().float()),
              power, f"B={b}, (B, 196, 768)")
    del xe
    x, attn, mlp, do = block_inputs(b, N, seed=256, device=device)
    for name, kernel, plain, _, count, c in kernel_cases(x, attn, mlp, do):
        if "other layout" in name:
            continue
        cases[name] = time_case(totals, name, kernel, plain, count, c, power,
                                tag + " (train step)")
    for name, kernel, plain, _ in op_cases(x, attn, mlp, do):
        time_chain(cases, name, kernel, plain, power, tag)
    del x, attn, mlp, do
    time_widths(b, device, power, tag)

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
    int8_ips = b / k_ms * 1e3
    del conv

    # the converted FP16_32 model of phase 6b
    conv = ViT(**dict(float_kwargs, converted=True), device=device)
    conv.load_state_dict(load_reference_checkpoint(float_ckpt), strict=True)
    conv.eval()
    with torch.inference_mode():
        k_ms, p_ms = paired_ms(lambda: conv(imgs),
                               lambda: conv(imgs, plain=True), iters=5,
                               warmup=2)
    print(f"timing: converted FP16_32 ViT-S/16 forward B={b}: kernel path "
          f"{k_ms:.3f} ms = {b / k_ms * 1e3:.1f} img/s, plain path "
          f"{p_ms:.3f} ms = {b / p_ms * 1e3:.1f} img/s; this run's bf16 "
          f"forward {bf16_ips:.1f} img/s, converted INT8 {int8_ips:.1f} "
          f"img/s [{power}]")
    with torch.inference_mode():
        conv(imgs)
        torch.cuda.synchronize()
        line = device_profile(lambda: conv(imgs), {
            "fake_quant_rows": ("fake_quant_rows",),
            "layernorm_snap_rows": ("layernorm_snap_rows",),
            "gemm_f32x3_epilogue": ("gemm_f32x3",),
            "attention_core_f32": ("attention_core_f32_wgmma",)})
    print(f"timing: converted FP16_32 forward profile (B={b}, one kernel-path "
          f"forward): {line} [{power}]")
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
    fp32_step = (k_ms, kernel_peak(lambda: kernel_step(state, batch,
                                                       tc["lr"])))
    line = device_profile(lambda: kernel_step(state, batch, tc["lr"]), {
        "gemm_bf16_epilogue": ("gemm_wgmma",),
        "attention_core": ("attention_core_kernel",),
        "attention_core_bwd": ("attention_core_bwd",),
        "LayerNorm, forward and backward": ("layernorm_rows",),
        "colsum_rows": ("colsum",)})
    print(f"timing: ViT-S/16 train step profile (B={b}, one kernel-path "
          f"step): {line} [{power}]")
    time_encode(imgs.device, power)
    del state, model
    qat_ms = time_qat_step(imgs, batch, tc, fp32_step, power)
    time_qat_int8_step(imgs, batch, tc, qat_ms, power)
    del imgs, batch
    time_detection(totals, device, power)
    time_detection_train(totals, device, power)
    time_float_detection(totals, device, power)
    time_int8_long(totals, device, power, int8_384_ckpt, int8_384_kwargs)
    return totals


def time_widths(b, device, power, tag):
    """K1-K4 at the widths of vit_tiny.json and vit_base.json, batch ``b``:
    each chain, kernel and plain, beside the sums of its kernels' bounds
    and yardsticks at that width (its own function, so that nothing of
    these inputs outlives it into the later timings and their peaks)."""
    for c_w, heads_w, hid_w, label in PROBE_WIDTHS:
        xw, aw, mw, dw = block_inputs(b, N, seed=c_w, device=device, c=c_w,
                                      hid=hid_w)
        cases = {}
        for name, _, _, _, count, cst in kernel_cases(xw, aw, mw, dw,
                                                      heads_w):
            if count:
                lib_ms = (None if cst["library"] is None
                          else cuda_ms(cst["library"]))
                least, by = bound(cst)
                cases[name] = (least, lib_ms, by)
        for name, kernel, plain, _ in op_cases(xw, aw, mw, dw, heads_w):
            if "recomputed" not in name:
                time_chain(cases, name, kernel, plain, power,
                           f"{tag}, {label}")


def time_encode(device, power):
    """The host cost of a GEMM launch's tensor maps: the two encodings of
    each gemm_bf16_epilogue launch (about 164 a ViT-S/16 train step),
    and one whole wrapper call of the smallest product, host clock, the
    device left to run."""
    from myrtle_vision_tpu_torch.ops import _kernels as K

    a = torch.zeros(256 * N, C, dtype=torch.bfloat16, device=device)
    w = torch.zeros(3 * C, C, dtype=torch.bfloat16, device=device).t()
    ns = K._lib().mvt_gemm_bf16_encode_ns(a.data_ptr(), w.data_ptr(),
                                          256 * N, 3 * C, C, 10000)
    check(ns >= 0, "tensor map encoding failed")
    small = a[:8]
    bias = torch.zeros(3 * C, device=device)
    K.gemm_bf16_epilogue_cuda(small, w, bias, "bias")
    torch.cuda.synchronize()
    calls = 2000
    t0 = time.perf_counter()
    for _ in range(calls):
        K.gemm_bf16_epilogue_cuda(small, w, bias, "bias")
    host_us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    print(f"timing: gemm_bf16_epilogue host cost: {ns / 1e3:.3f} us to "
          f"encode a launch's two tensor maps (mean of 10000), "
          f"{host_us:.2f} us a whole wrapper call (M=8, host clock) "
          f"[{power}]")


def kernel_peak(step):
    """Peak device memory of one call of ``step`` in GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2 ** 30


def time_qat_step(imgs, batch, tc, fp32_step, power):
    """One FP16_32 QAT train step of ViT-S/16 (forward, backward, AdamW)
    at the batch of the FP32 step, kernel and plain path, beside the FP32
    step of this run (``fp32_step``: its kernel-path ms and peak GiB);
    its peak device memory and a device profile of one kernel-path
    step."""
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

    b = imgs.shape[0]
    model = ViT("classification", 224, 16, 45, 384, 12, 6, 1536,
                q_format="FP16_32", device=imgs.device)
    state = TrainState(model, create_optimizer(tc, model))

    def plain_loss(mb):
        logits = model(mb["image"], plain=True)
        return cross_entropy_loss(logits, mb["label"]), {"metrics": {}}

    kernel_step = make_train_step(make_loss_fn(model), 1)
    plain_step = make_train_step(plain_loss, 1)
    k_ms, p_ms = paired_ms(lambda: kernel_step(state, batch, tc["lr"]),
                           lambda: plain_step(state, batch, tc["lr"]),
                           iters=3, warmup=1)
    peak = kernel_peak(lambda: kernel_step(state, batch, tc["lr"]))
    print(f"timing: ViT-S/16 FP16_32 QAT train step B={b} (forward, "
          f"backward, AdamW): kernel path {k_ms:.3f} ms = "
          f"{b / k_ms * 1e3:.1f} img/s, plain path {p_ms:.3f} ms = "
          f"{b / p_ms * 1e3:.1f} img/s, peak device memory {peak:.2f} GiB; "
          f"the FP32 step of this run {fp32_step[0]:.3f} ms = "
          f"{b / fp32_step[0] * 1e3:.1f} img/s, {fp32_step[1]:.2f} GiB "
          f"[{power}]")
    line = device_profile(lambda: kernel_step(state, batch, tc["lr"]), {
        "gemm_f32x3_epilogue": ("gemm_f32x3",),
        "attention_core_f32": ("attention_core_f32_wgmma",),
        "attention_core_f32_bwd": ("attention_core_f32_bwd_wgmma",),
        "LayerNorm, forward and backward": ("layernorm_snap_rows",
                                            "layernorm_rows_bwd"),
        "fake_quant_rows": ("fake_quant_rows",),
        "colsum_rows": ("colsum",)})
    print(f"timing: FP16_32 QAT train step profile (B={b}, one kernel-path "
          f"step): {line} [{power}]")
    return k_ms


def time_qat_int8_step(imgs, batch, tc, qat_ms, power):
    """One two-pass PyTorchINT8 QAT train step of ViT-S/16 (the
    calibrating pass, the differentiated pass, backward, AdamW) at the
    batch of the FP32 step, kernel and plain path, beside this run's
    FP16_32 QAT step (``qat_ms``); pass 1, pass 2 and the backward apart
    (CUDA events, the mean of three steps), the peak device memory and a
    device profile of one kernel-path step."""
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

    b = imgs.shape[0]
    model = ViT("classification", 224, 16, 45, 384, 12, 6, 1536,
                q_format="PyTorchINT8", device=imgs.device)
    state = TrainState(model, create_optimizer(tc, model))

    def plain_loss(mb):
        logits = two_pass(model, mb["image"], plain=True)
        return cross_entropy_loss(logits, mb["label"]), {"metrics": {}}

    kernel_step = make_train_step(make_loss_fn(model), 1)
    plain_step = make_train_step(plain_loss, 1)
    k_ms, p_ms = paired_ms(lambda: kernel_step(state, batch, tc["lr"]),
                           lambda: plain_step(state, batch, tc["lr"]),
                           iters=3, warmup=1)
    peak = kernel_peak(lambda: kernel_step(state, batch, tc["lr"]))
    img, labels = batch["image"][0], batch["label"][0]
    splits = []
    for _ in range(4):  # the first warms up
        model.zero_grad(set_to_none=True)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with torch.no_grad():
            model(img, calibrating=True)
        ev[1].record()
        loss = cross_entropy_loss(model(img, int8_fused=True), labels)
        ev[2].record()
        loss.backward()
        ev[3].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    p1, p2, bw = (sum(v) / 3 for v in zip(*splits[1:]))
    print(f"timing: ViT-S/16 PyTorchINT8 two-pass QAT train step B={b} "
          f"(calibrating pass, differentiated pass, backward, AdamW): kernel "
          f"path {k_ms:.3f} ms = {b / k_ms * 1e3:.1f} img/s, plain path "
          f"{p_ms:.3f} ms = {b / p_ms * 1e3:.1f} img/s, peak device memory "
          f"{peak:.2f} GiB; pass 1 {p1:.3f} ms, pass 2 {p2:.3f} ms, backward "
          f"{bw:.3f} ms (CUDA events, mean of 3); the FP16_32 QAT step of "
          f"this run {qat_ms:.3f} ms [{power}]")
    line = device_profile(lambda: kernel_step(state, batch, tc["lr"]), {
        "gemm_f32x3_epilogue": ("gemm_f32x3",),
        "attention_core_f32": ("attention_core_f32_wgmma",),
        "attention_core_f32_bwd": ("attention_core_f32_bwd_wgmma",),
        "LayerNorm, forward and backward": ("layernorm_snap_rows",
                                            "layernorm_rows_bwd"),
        "colsum_rows": ("colsum",)})
    print(f"timing: PyTorchINT8 two-pass QAT train step profile (B={b}, one "
          f"kernel-path step): {line} [{power}]")


def time_detection(totals, device, power):
    """The flash kernel per call at both regimes' shapes, beside its plain
    version, its bound and ``F.scaled_dot_product_attention`` on the same
    bf16 q, k, v; the K6 shape (800 px, batch 8) goes into the kernels
    line, once per block.  Then the YOLOS-S detection forward at 800 px,
    batch 8, kernel path against plain path."""
    import torch.nn.functional as F

    from myrtle_vision_tpu_torch.models.vit import ViT
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
    )

    for b, h, n, d, _, tag in FLASH_CASES[:2]:
        q, k, v = flash_inputs(b, h, n, d, seed=n + 1, device=device)
        sc = d ** -0.5
        c = cost(nbytes(q, k, v, q), 4 * b * h * n * n * d, "bf16",
                 lambda: F.scaled_dot_product_attention(q, k, v, scale=sc))
        time_case(totals, f"flash_attention_fwd[{tag}]",
                  lambda: K.flash_attention_fwd_cuda(q, k, v, sc),
                  lambda: flash_attention_plain(q, k, v, sc),
                  1 if tag.startswith("K6") else 0, c, power,
                  f"B={b} H={h} N={n} D={d}")
        exp_floor(f"flash_attention_fwd[{tag}]", b * h * n * n, power)
        del q, k, v

    time_yolos_forward(ViT("detection", 224, 16, 20, 384, 12, 6, 1536,
                           device=device), "",
                       {"flash_attention_fwd": ("flash_fwd_wgmma_kernel",)},
                       device, power)


def exp_floor(name, exps, power):
    """The least time the SFUs take for a flash case's ``exps``
    exponentials (``SFU_EXP_PER_S``), beside the operations bound: at head
    width 64 the softmax's exponentials take about as long as the
    products.  Printed on a line of its own; the kernels line keeps only
    the measured times and ``bound_ms``."""
    ms = exps / SFU_EXP_PER_S * 1e3
    print(f"timing: {name} exp floor {ms:.4f} ms ({exps} exponentials at "
          f"{SFU_EXP_PER_S:.4g} a second on the SFUs) [{power}]")


def sdpa_backward(q, k, v, do, scale):
    """A thunk of PyTorch's flash-attention backward (the yardstick) on
    bf16 (B, H, N, D) q, k, v and an output gradient; the forward's
    outputs are made at the first (warm-up) call."""
    fwd = []

    def run():
        if not fwd:
            fwd.extend(torch.ops.aten._scaled_dot_product_flash_attention(
                q, k, v, 0.0, False, False, scale=scale))
        out, lse, cq, ck, mq, mk, ps, po = fwd[:8]
        return torch.ops.aten._scaled_dot_product_flash_attention_backward(
            do, q, k, v, out, lse, cq, ck, mq, mk, 0.0, False, ps, po,
            scale=scale)

    return run


def time_detection_train(totals, device, power):
    """The flash backward per call at the K7 and K8 regimes' training
    shapes (batch 8), beside its plain version, its bound and PyTorch's
    flash-attention backward on the same inputs; the K7 shape (608 px)
    goes into the kernels line, once per block.  The long attention core
    forward (with SDPA's forward) and backward at N=677 (384 px), batch
    8 and the train step's micro-batch of 2.  Then the YOLOS-S train step
    (forward, backward with the host matcher, AdamW) at the config's 2
    micro-batches of 2, at 608 and 384 px, kernel path against plain
    path."""
    import torch.nn.functional as F

    from myrtle_vision_tpu_torch.models.vit import ViT
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops import fused_attention_block as fa
    from myrtle_vision_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain,
        flash_attention_plain,
    )

    for b, h, n, d, tag in ((8, 6, 1545, 64, "K7 regime, 608 px"),
                            (8, 6, 1125, 64, "K8 regime, 512 px")):
        q, k, v, do = flash_inputs(b, h, n, d, seed=n + 3, device=device,
                                   count=4)
        sc = d ** -0.5
        o, lse = K.flash_attention_fwd_cuda(q, k, v, sc, lse=True)
        o_p, lse_p = flash_attention_plain(q, k, v, sc, lse=True)
        # reads q, k, v, o, do and the LSE, writes dq, dk, dv; five
        # products of 2 N^2 D per (image, head)
        c = cost(nbytes(q, k, v, o, do) * 8 // 5 + nbytes(lse),
                 10 * b * h * n * n * d, "bf16",
                 sdpa_backward(q, k, v, do, sc))
        time_case(totals, f"flash_attention_bwd[{tag}]",
                  lambda: K.flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                     sc),
                  lambda: flash_attention_bwd_plain(q, k, v, o_p, do, lse_p,
                                                    sc),
                  1 if tag.startswith("K7") else 0, c, power,
                  f"B={b} H={h} N={n} D={d}")
        # p recomputed in both the dk / dv and the dq kernel
        exp_floor(f"flash_attention_bwd[{tag}]", 2 * b * h * n * n, power)
        del q, k, v, do, o, lse, o_p, lse_p

    # the fused core's long route (csrc/attention_core_long_wgmma.cu,
    # csrc/attention_core_bwd_long_wgmma.cu) at YOLOS-S's 384 px shape, at
    # batch 8 and at the train step's micro-batch of 2, each beside SDPA
    for b in (8, 2):
        n = 677
        x, attn, _, do = block_inputs(b, n, seed=8677, device=device)
        _, m, rs, qkv = fa._forward(K.PLAIN, x, *attn, HEADS, SCALE,
                                    record=True)[1]
        d_o = K.gemm_bf16_epilogue_plain(do.view(-1, C),
                                         attn[4].to(torch.bfloat16).t(), None,
                                         "f32").view(b, n, C)
        q, k, v = heads_of(qkv)
        dbq = torch.empty(b, 3 * C, device=device)
        tag = f"KV-tiled, 384 px{', B=2' if b == 2 else ''}"
        # reads the qkv rows, writes the context and both statistics; two
        # products of 2 N^2 D per (image, head)
        c = cost(nbytes(qkv) * 4 // 3 + 2 * nbytes(m),
                 4 * b * HEADS * n * n * (C // HEADS), "bf16",
                 lambda: F.scaled_dot_product_attention(q, k, v,
                                                        scale=SCALE))
        time_case(totals, f"attention_core[{tag}]",
                  lambda: K.attention_core_cuda(qkv, HEADS, SCALE,
                                                stats=True),
                  lambda: K.attention_core_plain(qkv, HEADS, SCALE,
                                                 stats=True),
                  0, c, power, f"B={b} N={n}")
        exp_floor(f"attention_core[{tag}]", b * HEADS * n * n, power)
        c = cost(2 * nbytes(qkv) + nbytes(d_o, m, rs, dbq),
                 10 * b * HEADS * n * n * (C // HEADS), "bf16",
                 sdpa_backward(q, k, v, heads_of(torch.cat([d_o.to(
                     torch.bfloat16)] * 3, -1))[0], SCALE))
        time_case(totals, f"attention_core_bwd[{tag}]",
                  lambda: K.attention_core_bwd_cuda(qkv, d_o, m, rs, HEADS,
                                                    SCALE),
                  lambda: K.attention_core_bwd_plain(qkv, d_o, m, rs, HEADS,
                                                     SCALE),
                  0, c, power, f"B={b} N={n}")
        # e recomputed in both walks of the dq kernel and in the dk / dv
        # kernel
        exp_floor(f"attention_core_bwd[{tag}]", 3 * b * HEADS * n * n,
                  power)
        del x, attn, do, m, rs, qkv, d_o, q, k, v

    time_yolos_step(ViT("detection", 224, 16, 20, 384, 12, 6, 1536,
                        device=device), "",
                    # the flash op's wgmma kernels, and the long-route
                    # kernels of the fused attention core above 256 tokens
                    # (forward and backward)
                    {"flash forward": ("flash_fwd_wgmma_kernel",),
                     "flash backward": ("flash_bwd_dsum_kernel",
                                        "flash_bwd_dkdv_wgmma_kernel",
                                        "flash_bwd_dq_wgmma_kernel"),
                     "long core forward": ("attention_core_long_kernel",),
                     "long core backward": ("core_long_prep_kernel",
                                            "core_long_dq_kernel",
                                            "core_long_dkdv_kernel",
                                            "core_long_colsum_kernel"),
                     "fused block kernels": ("attention_core_kernel",
                                             "attention_core_bwd_wgmma_kernel",
                                             "layernorm_rows",
                                             "gemm_wgmma_kernel",
                                             "colsum_kernel"),
                     "optimizer": ("multi_tensor",)}, device, power)


def time_yolos_step(model, label, groups, device, power, sizes=(608, 384),
                    name="YOLOS-S"):
    """The YOLOS train step of ``model`` (the config's 2 micro-batches of 2
    images: forward, backward with the host matcher, AdamW) at each of
    ``sizes`` px, kernel path against plain path, and a device profile of
    one kernel-path step by the kernel ``groups``; ``label`` names the
    format and ``name`` the model in the lines."""
    from myrtle_vision_tpu_torch.models.detector import (
        build_weight_dict,
        criterion,
    )
    from myrtle_vision_tpu_torch.training.detection import make_loss_fn
    from myrtle_vision_tpu_torch.training.optim import create_optimizer
    from myrtle_vision_tpu_torch.training.trainer import (
        TrainState,
        make_train_step,
    )

    tc = yolos_small_config()["train_config"]
    n_classes = model.decoder.class_embed.out_features - 1
    weights = build_weight_dict(tc)
    for size in sizes:
        rng = np.random.RandomState(size)
        valid = np.zeros((2, 2, 100), bool)
        for i, j in np.ndindex(2, 2):
            valid[i, j, :rng.randint(1, 21)] = True
        wh = rng.uniform(0.02, 0.3, (2, 2, 100, 2))
        cxy = wh / 2 + rng.uniform(0, 1, wh.shape) * (1 - wh)
        batch = {
            "image": seeded(rng, (2, 2, size, size, 3), 1.0, device),
            "labels": torch.from_numpy(rng.randint(0, n_classes,
                                                   (2, 2, 100))).to(device),
            "boxes": torch.from_numpy(np.concatenate([cxy, wh], -1).astype(
                np.float32)).to(device),
            "valid": torch.from_numpy(valid).to(device)}
        state = TrainState(model, create_optimizer(tc, model))

        def plain_loss(mb):
            # the INT8 detector's one-pass step runs no kernel: its plain
            # path is the same calibrating forward
            losses = criterion(model(mb["image"], plain=True,
                                     calibrating=model.int8),
                               {k: mb[k] for k in ("labels", "boxes",
                                                   "valid")},
                               n_classes, weight_dict=weights,
                               eos_coef=tc["eos_coef"])
            return losses.pop("loss"), {"metrics": losses}

        steps = [make_train_step(loss_fn, 2) for loss_fn in (
            make_loss_fn(model, n_classes, weights, tc["eos_coef"]),
            plain_loss)]
        k_ms, p_ms = paired_ms(lambda: steps[0](state, batch, tc["lr"]),
                               lambda: steps[1](state, batch, tc["lr"]),
                               iters=5, warmup=2)
        n_tok = tokens_of(size, size)
        print(f"timing: {name} {label}train step at {size} px ({n_tok} "
              f"tokens, 2 x 2 images: forward, backward with the host "
              f"matcher, AdamW): kernel path {k_ms:.3f} ms = "
              f"{4 / k_ms * 1e3:.2f} img/s, plain path {p_ms:.3f} ms = "
              f"{4 / p_ms * 1e3:.2f} img/s [{power}]")
        line = device_profile(lambda: steps[0](state, batch, tc["lr"]),
                              groups)
        print(f"timing: {name} {label}train step profile at {size} px (one "
              f"kernel-path step): {line} [{power}]")
        del state, steps, batch


def time_yolos_forward(model, label, groups, device, power):
    """The YOLOS-S forward of ``model`` at 800 px (2601 tokens), batch 8,
    kernel path against plain path, and where one kernel-path forward's
    device time goes: by the kernel ``groups``, cuBLAS products (the
    discrete blocks' projections) and everything else, and the device's
    idle share of the window from the first kernel's start to the last
    one's end (``torch.profiler``)."""
    b = 8
    gen = torch.Generator(device).manual_seed(1)
    imgs = torch.randn(b, 800, 800, 3, device=device, generator=gen)
    model.eval()
    with torch.inference_mode():
        k_ms, p_ms = paired_ms(lambda: model(imgs),
                               lambda: model(imgs, plain=True), iters=5,
                               warmup=2)
        print(f"timing: YOLOS-S {label}detection forward at 800 px (2601 "
              f"tokens) B={b}: kernel path {k_ms:.3f} ms = "
              f"{b / k_ms * 1e3:.2f} img/s, plain path {p_ms:.3f} ms = "
              f"{b / p_ms * 1e3:.2f} img/s [{power}]")
        model(imgs)
        torch.cuda.synchronize()
        line = device_profile(lambda: model(imgs), groups)
    print(f"timing: YOLOS-S {label}forward profile (800 px, B={b}, one "
          f"kernel-path forward): {line} [{power}]")


def time_float_detection(totals, device, power):
    """The float formats' long core per call at YOLOS-S's 384 px shape (N
    = 677, 6 heads of 64), at batch 8 and at the train step's micro-batch
    of 2, FP16_32 with the statistics (as the QAT forward runs it) and its
    backward, beside the plain version, the bound (the 3-pass products'
    bf16 operations, the bytes each reads once and writes once) and fp32
    ``F.scaled_dot_product_attention``, forward and backward (the
    yardstick of the short fp32 core); the (8, 677) cases go into the
    kernels line, once per block.  Then YOLOS-S in FP16_32: the train step
    (2 x 2 images, the host matcher, AdamW) at 608 and 384 px and the 800
    px eval forward at batch 8, kernel path against plain path, each with
    a device profile of one kernel-path call (the FP32 figures are
    time_detection's and time_detection_train's)."""
    import torch.nn.functional as F

    from myrtle_vision_tpu_torch.models.vit import ViT
    from myrtle_vision_tpu_torch.ops import _kernels as K

    qspec = FLOAT_QSPECS["FP16_32"]
    for b in (8, 2):
        n = 677
        rng = np.random.RandomState(8677 + b)
        qkv = seeded(rng, (b, n, 3 * C), 1.0, device)
        d_o = seeded(rng, (b, n, C), 1.0, device)
        _, m, rs = K.attention_context_f32(qkv, HEADS, SCALE, stats=True)
        q, k, v = heads_of(qkv)
        dbq = torch.empty(b, 3 * C, device=device)
        d_oh = heads_of(torch.cat([d_o] * 3, -1))[0]
        core = 4 * b * HEADS * n * n * (C // HEADS)  # two N x N x D products
        count = 1 if b == 8 else 0
        tag = f"B={b} N={n}"
        sdpa = []

        def sdpa_bwd():
            if not sdpa:
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                sdpa.append((F.scaled_dot_product_attention(
                    *leaves, scale=SCALE), leaves))
            out, leaves = sdpa[0]
            return torch.autograd.grad(out, leaves, d_oh, retain_graph=True)

        # reads the qkv rows, writes the context and both statistics; two
        # products of three passes
        c = cost(nbytes(qkv) * 4 // 3 + nbytes(m, rs), 3 * core, "bf16",
                 lambda: F.scaled_dot_product_attention(q, k, v,
                                                        scale=SCALE))
        time_case(totals, f"attention_core_f32_long[384 px, {tag}]",
                  lambda: K.attention_core_snap_cuda(qkv, HEADS, SCALE,
                                                     qspec, stats=True),
                  lambda: K.attention_core_snap_plain(qkv, HEADS, SCALE,
                                                      qspec, stats=True),
                  count, c, power, tag)
        # reads qkv, d_o, m, rs, writes dqkv and the column sums; five
        # products (s recomputed, dp, dv, dq, dk) of three passes
        c = cost(2 * nbytes(qkv) + nbytes(d_o, m, rs, dbq),
                 3 * core * 5 // 2, "bf16", sdpa_bwd)
        time_case(totals, f"attention_core_f32_bwd_long[384 px, {tag}]",
                  lambda: K.attention_core_f32_bwd_cuda(qkv, d_o, m, rs,
                                                        HEADS, SCALE),
                  lambda: K.attention_core_f32_bwd_plain(qkv, d_o, m, rs,
                                                         HEADS, SCALE),
                  count, c, power, tag)
        del qkv, d_o, m, rs, q, k, v, dbq, d_oh, sdpa

    time_sweep(totals, device, power)
    groups = {"long f32 core forward": ("f32_long_kv_split_kernel",
                                        "attention_core_f32_long_kernel",
                                        "attention_core_f32_cluster_kernel"),
              "long f32 core backward": ("f32_long_bwd_split_kernel",
                                         "f32_long_dq_kernel",
                                         "f32_long_dkdv_kernel",
                                         "f32_long_colsum_kernel"),
              "fake_quant_rows": ("fake_quant_rows",),
              "fused block kernels": ("layernorm_snap_rows", "gemm_f32x3",
                                      "layernorm_rows_bwd", "colsum_kernel"),
              "optimizer": ("multi_tensor",)}
    model = ViT("detection", 224, 16, 20, 192, 12, 3, 768,
                q_format="FP16_32", device=device)
    time_yolos_step(model, "FP16_32 QAT ", groups, device, power,
                    sizes=[s for s, _ in TINY_RUNS], name="YOLOS-Ti")
    del model
    model = ViT("detection", 224, 16, 20, 384, 12, 6, 1536,
                q_format="FP16_32", device=device)
    time_yolos_step(model, "FP16_32 QAT ",
                    {"long f32 core forward": (
                        "f32_long_kv_split_kernel",
                        "attention_core_f32_long_kernel"),
                     "long f32 core backward": ("f32_long_bwd_split_kernel",
                                                "f32_long_dq_kernel",
                                                "f32_long_dkdv_kernel",
                                                "f32_long_colsum_kernel"),
                     "fake_quant_rows": ("fake_quant_rows",),
                     "fused block kernels": ("layernorm_snap_rows",
                                             "gemm_f32x3",
                                             "layernorm_rows_bwd",
                                             "colsum_kernel"),
                     "optimizer": ("multi_tensor",)}, device, power)
    time_yolos_forward(model, "FP16_32 ",
                       {"fake_quant_rows": ("fake_quant_rows",)}, device,
                       power)


# the long fp32 core's timed shapes past its score block (B, heads, N, D):
# YOLOS-Ti's 480 px micro-batch and batch 8, and the gate's longest at one
# head of 32
SWEEP_TIMED = ((2, 3, 1001, 64), (8, 3, 1001, 64), (2, 1, 1837, 32))


def time_sweep(totals, device, power):
    """The long fp32 core past its score block (the forward's cluster
    design) per call at :data:`SWEEP_TIMED`, FP16_32 with the statistics
    and its backward, beside the plain version, the bound (the algorithm's
    products once: S and P V, and the backward's five, at three bf16
    passes and 989 TFLOP/s, or the bytes each reads once and writes once)
    and fp32 ``F.scaled_dot_product_attention`` forward and backward; each
    goes into the kernels line's cases (outside the ViT-S/16 block: count
    0).  Beside the forward, labelled, a second bound: S once on the FMA
    units, the design's own scores (3 D fp32 FMAs a score, every query
    against the keys padded to the tile, at 67 TFLOP/s), with the
    kernel's and its device time's share of each bound and the cluster the
    plan takes."""
    import torch.nn.functional as F

    from myrtle_vision_tpu_torch.ops import _kernels as K

    qspec = FLOAT_QSPECS["FP16_32"]
    for b, h, n, d in SWEEP_TIMED:
        c, sc = h * d, d ** -0.5
        rng = np.random.RandomState(9000 + n + b)
        qkv = seeded(rng, (b, n, 3 * c), 1.0, device)
        d_o = seeded(rng, (b, n, c), 1.0, device)
        _, m, rs = K.attention_context_f32(qkv, h, sc, stats=True)
        q, k, v = heads_of(qkv, h)
        dbq = torch.empty(b, 3 * c, device=device)
        d_oh = heads_of(torch.cat([d_o] * 3, -1), h)[0]
        core = 4 * b * h * n * n * d  # two N x N x D products
        tag = f"B={b} H={h} N={n} D={d}"
        sdpa = []

        def sdpa_bwd():
            if not sdpa:
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                sdpa.append((F.scaled_dot_product_attention(
                    *leaves, scale=sc), leaves))
            out, leaves = sdpa[0]
            return torch.autograd.grad(out, leaves, d_oh, retain_graph=True)

        cf = cost(nbytes(qkv) * 4 // 3 + nbytes(m, rs), 3 * core, "bf16",
                  lambda: F.scaled_dot_product_attention(q, k, v, scale=sc))
        b_ms, _, _, k_ms, dev_ms = time_case(
            totals, f"attention_core_f32_long[cluster, {tag}]",
            lambda: K.attention_core_snap_cuda(qkv, h, sc, qspec, stats=True),
            lambda: K.attention_core_snap_plain(qkv, h, sc, qspec,
                                                stats=True),
            0, cf, power, tag)
        plan = K.f32_long_plan(n, d, b, h)
        fma = 3 * d * plan["n_pad"] * n * b * h  # S once, the keys padded
        f_ms = bound(cost(0, 2 * fma, "fp32"))[0]
        dev = ("device not measured" if dev_ms is None else
               f"device {dev_ms:.4f} ms, {b_ms / dev_ms:.4f} / "
               f"{f_ms / dev_ms:.4f} of them")
        print(f"timing: attention_core_f32_long[cluster, {tag}] bound "
              f"{b_ms:.4f} ms (S and P V once, three bf16 passes at 989 "
              f"TFLOP/s); S-once FMA bound {f_ms:.4f} ms ({fma} fp32 FMAs "
              f"at 67 TFLOP/s); kernel {k_ms:.4f} ms, {b_ms / k_ms:.4f} / "
              f"{f_ms / k_ms:.4f} of them; {dev}; a cluster of "
              f"{plan['fwd']['cluster']} CTAs, {plan['fwd']['stages']} key "
              f"tiles each, {plan['fwd']['grid'] * b * h} CTAs [{power}]")
        cb = cost(2 * nbytes(qkv) + nbytes(d_o, m, rs, dbq),
                  3 * core * 5 // 2, "bf16", sdpa_bwd)
        time_case(totals, f"attention_core_f32_bwd_long[past 768, {tag}]",
                  lambda: K.attention_core_f32_bwd_cuda(qkv, d_o, m, rs, h,
                                                        sc),
                  lambda: K.attention_core_f32_bwd_plain(qkv, d_o, m, rs, h,
                                                         sc),
                  0, cb, power, tag)
        print(f"timing: the long f32 core at {tag}: "
              f"{K.F32_LONG_FWD_LAUNCHES} launches a forward call, "
              f"{K.F32_LONG_BWD_LAUNCHES} a backward call [{power}]")
        del qkv, d_o, m, rs, q, k, v, dbq, d_oh, sdpa


def time_int8_long(totals, device, power, int8_384_ckpt, int8_384_kwargs):
    """PyTorchINT8 above 256 tokens.  The long core's int8 modes per call
    at ViT-S/16's 384 px shape (B=8, N=577, 6 heads of 64), the site mode
    with the statistics (as pass 2 runs it) and the int8 grid, beside the
    plain version, the bound (the 3-pass products' bf16 operations, the
    bytes each reads once and writes once) and a yardstick (fp32
    ``F.scaled_dot_product_attention`` followed by the site's quantize,
    two PyTorch calls; no one call does both); each into the kernels line,
    once per block.  ``layernorm_snap_rows`` at the 384 px step's rows at
    B=256 (147,712) with a calibrated site, beside ``F.layer_norm``.  The
    K1 / K2 int8 and K9 chains at (8, 577).  Then
    the 384 px two-pass QAT step at the largest batch of 256, 128, ... that
    fits, with its peak memory, the passes apart and a device profile; the
    converted 384 px forward at B=256 (the PTQ checkpoint of phase
    int8-384); the YOLOS-S INT8 QAT step at 608 and 384 px and its 800 px
    forward at batch 8, each with a device profile (idle share)."""
    import torch.nn.functional as F

    from myrtle_vision_tpu_torch.models.vit import ViT
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites
    from myrtle_vision_tpu_torch.quantize import affine_uint8_qparams
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

    b, n = 8, 577
    tag = f"B={b} N={n}"
    rng = np.random.RandomState(8577 + 7)
    qkv = seeded(rng, (b, n, 3 * C), 1.0, device)
    site = long_int8_site(qkv, HEADS, SCALE)
    q, k, v = heads_of(qkv)
    core = 4 * b * HEADS * n * n * (C // HEADS)  # two N x N x D products

    def sdpa_ctx():
        return F.scaled_dot_product_attention(q, k, v, scale=SCALE
                                              ).transpose(1, 2).reshape(
            b, n, C)

    m_rs = 2 * b * HEADS * n * 4
    sites_key, out_key = LONG_INT8_KERNELS
    for key, kernel, plain, out_bytes, yard in (
            (sites_key,
             lambda: K.attention_core_snap_cuda(qkv, HEADS, SCALE,
                                                Int8Sites(site), stats=True),
             lambda: K.attention_core_snap_plain(qkv, HEADS, SCALE,
                                                 Int8Sites(site), stats=True),
             b * n * C * 4 + m_rs,
             lambda: K.requant(sdpa_ctx(), site)),
            (out_key,
             lambda: K.attention_core_f32_cuda(qkv, HEADS, SCALE, site),
             lambda: K.attention_core_f32_plain(qkv, HEADS, SCALE, site),
             b * n * C, lambda: K.quantize_i8(sdpa_ctx(), site))):
        acc = {}
        c = cost(nbytes(qkv) + out_bytes, 3 * core, "bf16", yard)
        time_case(acc, f"{key.split('[')[0]}[384 px ViT-S/16, "
                  f"{key.split('[')[1]}", kernel, plain, 1, c, power, tag)
        totals[key] = acc["attention_core_f32_long"]
    # K2 int8's core above 256 tokens: the long backward as the float
    # formats run it, from the site mode's statistics (outside the kernels
    # line's sums: that entry is the FP16_32 step's)
    d_o = seeded(rng, (b, n, C), 1.0, device)
    _, m, rs = K.attention_core_snap_cuda(qkv, HEADS, SCALE, Int8Sites(site),
                                          stats=True)
    dbq = torch.empty(b, 3 * C, device=device)
    d_oh = heads_of(torch.cat([d_o] * 3, -1))[0]
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves, scale=SCALE)
    c = cost(2 * nbytes(qkv) + nbytes(d_o, m, rs, dbq), 3 * core * 5 // 2,
             "bf16", lambda: torch.autograd.grad(sdpa_out, leaves, d_oh,
                                                 retain_graph=True))
    time_case({}, "attention_core_f32_bwd_long[384 px ViT-S/16, int8 QAT]",
              lambda: K.attention_core_f32_bwd_cuda(qkv, d_o, m, rs, HEADS,
                                                    SCALE),
              lambda: K.attention_core_f32_bwd_plain(qkv, d_o, m, rs, HEADS,
                                                     SCALE), 0, c, power, tag)
    del qkv, q, k, v, d_o, m, rs, dbq, d_oh, leaves, sdpa_out
    # K1 / K3 int8's LayerNorm prologue at the 384 px step's rows, B=256
    # (pass 2 runs it twice a block), a site calibrated on its output;
    # outside the kernels line's sums (that entry is the 224 px forward's)
    xl = seeded(rng, (INT8_384_BATCH * n, C), 1.0, device)
    s_l = seeded(rng, (C,), 0.1, device) + 1
    b_l = seeded(rng, (C,), 0.1, device)
    y = F.layer_norm(xl, (C,), s_l, b_l, K.EPS)
    s, zp = affine_uint8_qparams(y.min(), y.max())
    ln_site = Int8Sites(torch.stack([s, zp, torch.ones_like(s)]))
    del y
    time_case({}, "layernorm_snap_rows[384 px ViT-S/16, int8]",
              lambda: K.layernorm_snap_rows_cuda(xl, s_l, b_l, ln_site),
              lambda: K.layernorm_snap_rows_plain(xl, s_l, b_l, ln_site), 0,
              cost(2 * nbytes(xl) + nbytes(s_l, b_l), 14 * xl.numel(),
                   "fp32", lambda: F.layer_norm(xl, (C,), s_l, b_l, K.EPS)),
              power, f"B={INT8_384_BATCH} N={n}")
    del xl

    x, attn, mlp, sites = qat_int8_block_inputs(b, n, seed=8580,
                                                device=device)
    do = seeded(np.random.RandomState(8581), (b, n, C), 1.0, device)
    for name, kernel, plain, _ in qat_int8_op_cases(x, attn, mlp, do, sites):
        if name.startswith("fused_attention_block_i8") and \
                "recomputed" not in name:
            time_chain({}, f"{name} (384 px)", kernel, plain, power,
                       tag + " (INT8 QAT step)")
    del x, attn, mlp, sites, do
    xi, ai, mi, ci = int8_block_inputs(b, n, seed=8582, device=device)
    for name, kernel, plain, _ in int8_op_cases(xi, ai, mi, ci):
        time_chain({}, f"{name} (384 px)", kernel, plain, power,
                   tag + " (converted forward)")
    del xi, ai, mi, ci

    # the 384 px two-pass step at the largest batch that fits
    tc = vit_small_config()["train_config"]
    model = ViT("classification", 384, 16, 45, 384, 12, 6, 1536,
                q_format="PyTorchINT8", device=device)
    state = TrainState(model, create_optimizer(tc, model))
    gen = torch.Generator(device).manual_seed(384)
    step = make_train_step(make_loss_fn(model), 1)
    b = INT8_384_BATCH
    while True:
        imgs = torch.randn(b, 384, 384, 3, device=device, generator=gen)
        batch = {"image": imgs[None],
                 "label": torch.randint(0, 45, (1, b), device=device,
                                        generator=gen)}
        try:
            peak = kernel_peak(lambda: step(state, batch, tc["lr"]))
            break
        except torch.cuda.OutOfMemoryError:
            del imgs, batch
            torch.cuda.empty_cache()
            check(b > 8, "the 384 px INT8 QAT step fits no batch")
            print(f"timing: the 384 px INT8 QAT step at B={b} does not fit "
                  "in the card's memory; halving")
            b //= 2

    def plain_loss(mb):
        logits = two_pass(model, mb["image"], plain=True)
        return cross_entropy_loss(logits, mb["label"]), {"metrics": {}}

    plain_step = make_train_step(plain_loss, 1)
    try:
        k_ms, p_ms = paired_ms(lambda: step(state, batch, tc["lr"]),
                               lambda: plain_step(state, batch, tc["lr"]),
                               iters=2, warmup=1)
        plain = f"{p_ms:.3f} ms = {b / p_ms * 1e3:.2f} img/s"
    except torch.cuda.OutOfMemoryError:
        torch.cuda.empty_cache()
        k_ms = cuda_ms(lambda: step(state, batch, tc["lr"]), 2, 1)
        plain = "not measured (out of memory at this batch)"
    splits = []
    for _ in range(3):  # the first warms up
        model.zero_grad(set_to_none=True)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        with torch.no_grad():
            model(imgs, calibrating=True)
        ev[1].record()
        loss = cross_entropy_loss(model(imgs, int8_fused=True),
                                  batch["label"][0])
        ev[2].record()
        loss.backward()
        ev[3].record()
        torch.cuda.synchronize()
        splits.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    p1, p2, bw = (sum(v) / 2 for v in zip(*splits[1:]))
    print(f"timing: ViT-S/16 at 384 px ({n} tokens) PyTorchINT8 two-pass QAT "
          f"train step B={b} (calibrating pass, differentiated pass, "
          f"backward, AdamW): kernel path {k_ms:.3f} ms = "
          f"{b / k_ms * 1e3:.2f} img/s, plain path {plain}, peak device "
          f"memory (max_memory_allocated) {peak:.2f} GiB; pass 1 {p1:.3f} ms, pass "
          f"2 {p2:.3f} ms, backward {bw:.3f} ms (CUDA events, mean of 2) "
          f"[{power}]")
    line = device_profile(lambda: step(state, batch, tc["lr"]), {
        "attention_core_f32_long (site mode)": (
            "f32_long_kv_split_kernel", "attention_core_f32_long_kernel"),
        "attention_core_f32_bwd_long": ("f32_long_bwd_split_kernel",
                                        "f32_long_dq_kernel",
                                        "f32_long_dkdv_kernel",
                                        "f32_long_colsum_kernel"),
        "gemm_f32x3_epilogue": ("gemm_f32x3",),
        "LayerNorm, forward and backward": ("layernorm_snap_rows",
                                            "layernorm_rows_bwd"),
        "colsum_rows": ("colsum",)})
    print(f"timing: 384 px PyTorchINT8 two-pass QAT step profile (B={b}, one "
          f"kernel-path step): {line} [{power}]")
    del state, model, step, plain_step, batch, imgs

    # the converted 384 px model of phase int8-384
    b = INT8_384_BATCH
    imgs = torch.randn(b, 384, 384, 3, device=device, generator=gen)
    conv = ViT(**dict(int8_384_kwargs, converted=True), device=device)
    conv.load_state_dict(load_reference_checkpoint(int8_384_ckpt),
                         strict=True)
    conv.eval()
    with torch.inference_mode():
        k_ms, p_ms = paired_ms(lambda: conv(imgs),
                               lambda: conv(imgs, plain=True), iters=5,
                               warmup=2)
        line = device_profile(lambda: conv(imgs), {
            "attention_core_f32_long (int8 mode)": (
                "f32_long_kv_split_kernel",
                "attention_core_f32_long_kernel"),
            "gemm_s8_epilogue": ("gemm_s8",),
            "layernorm_quant_rows": ("layernorm_quant_rows",)})
    print(f"timing: converted INT8 ViT-S/16 forward at 384 px B={b}: kernel "
          f"path {k_ms:.3f} ms = {b / k_ms * 1e3:.1f} img/s, plain path "
          f"{p_ms:.3f} ms = {b / p_ms * 1e3:.1f} img/s; profile: {line} "
          f"[{power}]")
    del conv, imgs

    model = ViT("detection", 224, 16, 20, 384, 12, 6, 1536,
                q_format="PyTorchINT8", device=device)
    time_yolos_step(model, "PyTorchINT8 QAT ", {}, device, power)
    time_yolos_forward(model, "PyTorchINT8 ", {}, device, power)


# ------------------------------------------------------------ fp32 compute
#
# compute_dtype float32 (phases kernels-f32, fp32 and remainder).  The fp32
# flash kernels run every product as 3xTF32 on the tensor cores (each
# operand split into tf32 hi and lo, three passes: about 2^-22 of each
# product off true fp32), their plain versions true fp32: bar per element
# 2^-14 of |plain| plus 2^-14 of the largest |plain| (the output and the
# LSE), 2^-12 of the largest for dq, dk and dv.  The fp32
# K1-K4 route runs the qspec chains' kernels snapping nothing, whose 3-pass
# bf16 products lose about 2^-16 of each product against the plain chains'
# true fp32: 2^-10 of |plain| plus 2^-10 of the largest for the outputs and
# dx, 2^-8 of the largest for the parameter gradients (sums over the B N
# rows).  tests/test_torch_kernels_cuda.py holds the same bars.
F32_FLASH_RTOL = 2.0 ** -14
F32_FLASH_ATOL = 2.0 ** -14
F32_FLASH_GRAD_ATOL = 2.0 ** -12
F32_CHAIN_RTOL = 2.0 ** -10
F32_CHAIN_ATOL = 2.0 ** -10
F32_CHAIN_SUM_ATOL = 2.0 ** -8
# fp32 flash cases (B, H, N, D, n_valid, tag): YOLOS-S's 800 px eval (K6),
# ViT-S/16 under MVT_NO_FUSE=1 (K5), a ragged case with masked keys; the
# backward at YOLOS-S's 608 px step (K7) and ViT-S/16 (K8)
F32_FLASH_CASES = [(8, 6, 2601, 64, None, "K6 regime, 800 px"),
                   (64, 6, 197, 64, None, "K5 regime, ViT-S/16"),
                   (3, 2, 50, 32, 40, "ragged, n_valid 40")]
F32_FLASH_BWD_CASES = [(2, 6, 1545, 64, None, "K7 regime, 608 px"),
                       (64, 6, 197, 64, None, "K8 regime, ViT-S/16"),
                       (3, 2, 50, 32, 40, "ragged, n_valid 40")]
# the fp32 K1-K4 route's cases (B, N, tag): ViT-S/16, and YOLOS-S at 384
# px, the long fp32 core
F32_CHAIN_CASES = ((64, N, "ViT-S/16", C, HEADS, HID),
                   (4, 677, "YOLOS-S 384 px", C, HEADS, HID),
                   (2, 1001, "YOLOS-Ti 480 px", 192, 3, 768))
F32_KERNELS = {
    "flash_attention_f32_fwd": (
        f"{CSRC}flash_attention_f32_fwd_wgmma.cu; {CSRC}flash_tf32.cuh",
        f"{TPU_FLASH} (fp32)"),
    "flash_attention_f32_bwd": (
        f"{CSRC}flash_attention_f32_bwd_wgmma.cu; {CSRC}flash_tf32.cuh",
        f"{TPU_FLASH_BWD} (fp32)"),
}
# the fp32 K1-K4 route in the kernels line: (its sources, the TPU kernel
# it replaces, its TPU chain's name)
F32_ROUTE = {
    "fused_attention_block[fp32]": (
        f"{_Q_SRC}; {CSRC}attention_core_f32_long_wgmma.cu",
        f"{TPU_ATTN} (fp32)", "K1 fp32"),
    "fused_attention_block[fp32,bwd]": (
        f"{_Q_BWD_SRC}; {CSRC}attention_core_f32_bwd_long_wgmma.cu",
        f"{TPU_ATTN_BWD} (fp32)", "K2 fp32"),
    "fused_mlp_block[fp32]": (
        f"{CSRC}layernorm_snap_rows.cu; {CSRC}gemm_f32x3_wgmma.cu",
        f"{TPU_MLP} (fp32)", "K3 fp32"),
    "fused_mlp_block[fp32,bwd]": (
        _Q_BWD_SRC.replace(f"{CSRC}attention_core_f32_bwd_wgmma.cu; ", ""),
        f"{TPU_MLP_BWD} (fp32)", "K4 fp32"),
}
# the fp32 chain's kernels, and the bf16 chain's, which an fp32 step must
# not launch
F32_CHAIN_KERNELS = ("layernorm_snap_rows", "gemm_f32x3_epilogue",
                     "layernorm_snap_rows_bwd", "colsum_rows")
BF16_CHAIN_KERNELS = ("layernorm_rows", "gemm_bf16_epilogue",
                      "attention_core", "attention_core_bwd",
                      "layernorm_rows_bwd")
# the classifier's train CLI runs of these phases: images of the train
# split (the epoch's depth cut; widths as the config): 3 steps of 64 in
# fp32, 4 with dropout (the profiler's window starts at step 3)
F32_TRAIN_IMAGES = 192
DROPOUT_TRAIN_IMAGES = 256
DROPOUT = 0.1


def f32_close(label, got, ref, rtol, atol_share):
    """:func:`compare` of fp32 against fp32, the atol a share of the
    largest |ref| (at least 1)."""
    return compare(label, got, ref, rtol,
                   atol_share * max(1.0, ref.abs().max().item()))


def f32_views(b, n, h, d, seed, device):
    """fp32 q, k, v: (B, H, N, D) views of fused (B, N, 3 H D) qkv rows,
    std 1, from a numpy seed, as the discrete Block hands them over."""
    rng = np.random.RandomState(seed)
    rows = seeded(rng, (b, n, 3 * h * d), 1.0, device)
    return list(rows.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4))


def leaf_grads(fn, x, params, extra, do):
    """Every input's gradient of ``fn(x, *params, *extra)`` under the
    output gradient ``do``."""
    leaves = [t.detach().clone().requires_grad_() for t in (x, *params)]
    fn(*leaves, *extra).backward(do)
    torch.cuda.synchronize()
    return [t.grad for t in leaves]


def phase_kernels_f32(device):
    """The fp32 flash kernels (K5 / K6 forward, K7 / K8 backward) against
    their plain versions at :data:`F32_FLASH_CASES` and
    :data:`F32_FLASH_BWD_CASES`, two and four launches a call, and the
    fp32 K1-K4 route (the qspec chains with no snap) against the plain
    chains' true fp32 at :data:`F32_CHAIN_CASES`, forward and backward;
    returns the largest max abs of each kernels-line entry."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops import fused_attention_block as fa
    from myrtle_vision_tpu_torch.ops import fused_mlp as fm
    from myrtle_vision_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain,
        flash_attention_plain,
    )

    errors = dict.fromkeys(list(F32_KERNELS) + list(F32_ROUTE), 0.0)
    for b, h, n, d, n_valid, tag in F32_FLASH_CASES:
        q, k, v = f32_views(b, n, h, d, 22000 + n, device)
        reset_counts()
        got = K.flash_attention_f32_fwd_cuda(q, k, v, d ** -0.5, n_valid,
                                             lse=True)
        launched = read_counts()[0]["flash_attention_f32_fwd"]
        ref = flash_attention_plain(q, k, v, d ** -0.5, n_valid, lse=True)
        res = [f32_close(f"flash_attention_f32_fwd {tag} {part}", g, r,
                         F32_FLASH_RTOL, F32_FLASH_ATOL)
               for g, r, part in zip(got, ref, ("output", "LSE"))]
        check(launched == K.F32_FLASH_FWD_LAUNCHES,
              f"flash_attention_f32_fwd: {launched} launches")
        errors["flash_attention_f32_fwd"] = max(
            errors["flash_attention_f32_fwd"], *(m for m, _ in res))
        print(f"kernels: flash_attention_f32_fwd B={b} H={h} N={n} D={d} "
              f"n_valid={n_valid or n} ({tag}) max_abs "
              f"{max(m for m, _ in res):.6g}, {max(s for _, s in res):.4f} "
              f"of the fp32 flash bar (output, LSE)")
        del q, k, v, got, ref
    for b, h, n, d, n_valid, tag in F32_FLASH_BWD_CASES:
        q, k, v = f32_views(b, n, h, d, 23000 + n, device)
        do = seeded(np.random.RandomState(n), (b, h, n, d), 1.0, device)
        sc = d ** -0.5
        o, lse = K.flash_attention_f32_fwd_cuda(q, k, v, sc, n_valid,
                                                lse=True)
        reset_counts()
        got = K.flash_attention_f32_bwd_cuda(q, k, v, o, do, lse, sc,
                                             n_valid)
        launched = read_counts()[0]["flash_attention_f32_bwd"]
        ref = flash_attention_bwd_plain(q, k, v, o, do, lse, sc, n_valid)
        res = [f32_close(f"flash_attention_f32_bwd {tag} {part}", g, r,
                         F32_FLASH_RTOL, F32_FLASH_GRAD_ATOL)
               for g, r, part in zip(got, ref, ("dq", "dk", "dv"))]
        check(launched == K.F32_FLASH_BWD_LAUNCHES,
              f"flash_attention_f32_bwd: {launched} launches")
        errors["flash_attention_f32_bwd"] = max(
            errors["flash_attention_f32_bwd"], *(m for m, _ in res))
        print(f"kernels: flash_attention_f32_bwd B={b} H={h} N={n} D={d} "
              f"n_valid={n_valid or n} ({tag}), both from the kernel "
              f"forward's o and LSE: max_abs {max(m for m, _ in res):.6g}, "
              f"{max(s for _, s in res):.4f} of the fp32 flash bar (dq, dk, "
              "dv)")
        del q, k, v, do, o, lse, got, ref
    for b, n, tag, c, heads, hid in F32_CHAIN_CASES:
        x, attn, mlp, do = block_inputs(b, n, 24000 + n, device, c, hid)
        x, do = x.float(), do.float()
        for op, plain, params, extra, name in (
                (fa.fused_attention_block, fa.fused_attention_block_plain,
                 attn, (heads, (c // heads) ** -0.5),
                 "fused_attention_block[fp32]"),
                (fm.fused_mlp_block, fm.fused_mlp_block_plain, mlp, (),
                 "fused_mlp_block[fp32]")):
            reset_counts()
            got = op(x, *params, *extra)
            grads = leaf_grads(op, x, params, extra, do)
            launched = {k: v for k, v in read_counts()[0].items() if v}
            check(not any(k in launched for k in BF16_CHAIN_KERNELS)
                  and all(launched.get(k, 0) > 0 for k in F32_CHAIN_KERNELS),
                  f"{name} {tag}: launches {launched}")
            fwd = f32_close(f"{name} {tag}", got,
                            plain(x, *params, *extra), F32_CHAIN_RTOL,
                            F32_CHAIN_ATOL)
            ref = leaf_grads(plain, x, params, extra, do)
            bwd = [f32_close(f"{name} {tag} d{i}", g, r, F32_CHAIN_RTOL,
                             F32_CHAIN_ATOL if i == 0 else F32_CHAIN_SUM_ATOL)
                   for i, (g, r) in enumerate(zip(grads, ref))]
            bname = name.replace("]", ",bwd]")
            errors[name] = max(errors[name], fwd[0])
            errors[bname] = max(errors[bname], *(m for m, _ in bwd))
            print(f"kernels: {name} B={b} N={n} ({tag}) forward max_abs "
                  f"{fwd[0]:.6g} ({fwd[1]:.4f} of the fp32 chain bar), "
                  f"backward max_abs {max(m for m, _ in bwd):.6g} "
                  f"({max(s for _, s in bwd):.4f} of its bars: dx, then the "
                  f"parameters); launches of a forward and a backward "
                  f"{launched}")
        del x, attn, mlp, do
    return errors


def f32_config(config):
    """A config with float32 compute (``vit_config.compute_dtype``)."""
    config["vit_config"]["compute_dtype"] = "float32"
    return config


def subset_data_config(data_config, images, name):
    """The data config with its train split cut to the first ``images``
    images (the epoch's depth; every width stays), written beside it."""
    root = data_config["dataset_path"]
    with open(os.path.join(root, data_config["train_files"])) as f:
        lines = f.read().split()
    split = f"{name}_train_imagepaths.txt"
    with open(os.path.join(root, split), "w") as f:
        f.write("\n".join(lines[:images]) + "\n")
    return write_json(f"{name}_data_config.json",
                      dict(data_config, train_files=split))


def run_train_cli(config, name, tag):
    """The classification train CLI on ``config``; returns (state, its
    printed losses, kernel launches, op launches, seconds, run dir)."""
    from myrtle_vision_tpu_torch.classification import train as train_cli

    cfg = write_json(f"{name}.json", config)
    reset_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        state = train_cli.main(["-c", cfg, "--device", "cuda"])
    launches, ops = read_counts()
    took = time.perf_counter() - t0
    text = out.getvalue()
    for line in text.splitlines():
        if line.startswith(("Iteration", "WARNING", "[profiler]")):
            print(f"{tag}: {line}")
    losses = [float(v) for v in
              re.findall(r"Iteration \d+:\tloss=(\S+)\tacc=", text)]
    check(len(losses) == state.iteration >= 2
          and all(math.isfinite(v) for v in losses),
          f"{tag}: {state.iteration} steps, losses {losses}")
    run_dir = sorted(glob.glob(
        config["train_config"]["output_directory"] + "_*"))[-1]
    return state, losses, launches, ops, took, run_dir


def f32_step_launches(n_tok, n_accum, depth):
    """The attention kernels' launches of one fp32 YOLOS-S train step at
    ``n_tok`` tokens: per block and micro-batch, fused, the fp32 core (two
    kernels above 256 tokens) and its backward (four there); past the gate
    one fp32 flash forward (two kernels) and one backward (four)."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.fused_attention_block import fuses_at

    blocks = depth * n_accum
    want = dict.fromkeys(("attention_core_f32", "attention_core_f32_bwd",
                          "attention_core_f32_long",
                          "attention_core_f32_bwd_long",
                          "flash_attention_f32_fwd",
                          "flash_attention_f32_bwd"), 0)
    if not fuses_at(n_tok, HEADS, C // HEADS):
        want.update(
            flash_attention_f32_fwd=K.F32_FLASH_FWD_LAUNCHES * blocks,
            flash_attention_f32_bwd=K.F32_FLASH_BWD_LAUNCHES * blocks)
    elif n_tok > 256:
        want.update(attention_core_f32_long=2 * blocks,
                    attention_core_f32_bwd_long=4 * blocks)
    else:
        want.update(attention_core_f32=blocks,
                    attention_core_f32_bwd=blocks)
    return want


def phase_fp32(device, data_config, det_data):
    """compute_dtype float32 on the card, every width as configured:
    (a) ViT-S/16 (vit_small.json with float32 compute): the train CLI for
    3 steps of 2 x 32 through the fused fp32 K1-K4 route (launches of
    both ops, forward and backward; no bf16 chain kernel), the first step
    kernel vs plain, the last checkpoint through the eval CLI; (b) the
    same under MVT_NO_FUSE=1: the discrete Blocks, the fp32 flash K5 / K8
    (launches counted), the first step kernel vs plain; (c) YOLOS-S
    (yolos_small.json with float32 compute, random weights): the 800 px
    forward at B=2 (2601 tokens: K6 on fp32) kernel vs plain, and the first
    train step (2 x 2) at 608 px (1545 tokens: K6 and K7 on fp32) and 384
    px (677 tokens: the fused route through the long fp32 core) kernel vs
    plain.  Returns ({kernels-line name: launches}, the fp32 checkpoint
    and its config)."""
    from myrtle_vision_tpu_torch.classification import test as eval_cli
    from myrtle_vision_tpu_torch.classification import train as train_cli
    from myrtle_vision_tpu_torch.models.detector import build_weight_dict
    from myrtle_vision_tpu_torch.models.vit import ViT, vit_kwargs_from_config
    from myrtle_vision_tpu_torch.ops import _kernels as K

    t_phase = time.perf_counter()
    config = f32_config(vit_small_config())
    depth = config["vit_config"]["depth"]
    tc = config["train_config"]
    tc.update(checkpoint_path="", epochs=1, warmup_epochs=0,
              pretrained_backbone=None, iters_per_checkpoint=100,
              iters_per_val=100)
    config["data_config_path"] = subset_data_config(
        data_config, F32_TRAIN_IMAGES, "fp32")
    with contextlib.redirect_stdout(io.StringIO()):
        model, train_loader, val_loader, (micro, n_accum) = \
            train_cli.build_train(config, device)
    val_batches = len(val_loader)
    runs = {}

    # (a) the fused route
    tc["output_directory"] = os.path.join(WORK, "fp32_train")
    state, losses, launches, ops, took, run_dir = run_train_cli(
        config, "vit_small_fp32_train", "fp32")
    steps = state.iteration
    bwd = depth * n_accum * steps
    fwd = bwd + depth * val_batches
    print(f"fp32: ViT-S/16 train CLI with float32 compute, {steps} steps of "
          f"{n_accum} x {micro} and a validation of {val_batches} batches in "
          f"{took:.1f} s: op launches {ops}, expected ({fwd}, {bwd}) each; "
          f"kernels {launches}")
    for op in ("fused_attention_block", "fused_mlp_block"):
        check(ops[op] == (fwd, bwd), f"fp32: {op} launches {ops[op]}")
    check(not any(launches[k] for k in BF16_CHAIN_KERNELS)
          and all(launches[k] > 0 for k in F32_CHAIN_KERNELS
                  + ("attention_core_f32", "attention_core_f32_bwd")),
          f"fp32: kernels {launches}")
    runs.update({"fused_attention_block[fp32]": ops["fused_attention_block"][0],
                 "fused_attention_block[fp32,bwd]":
                     ops["fused_attention_block"][1],
                 "fused_mlp_block[fp32]": ops["fused_mlp_block"][0],
                 "fused_mlp_block[fp32,bwd]": ops["fused_mlp_block"][1]})
    first_step_check(model, train_loader, os.path.join(run_dir, "vit_000000"),
                     n_accum, micro, losses[0], tag="fp32")
    ckpt = os.path.join(run_dir, f"vit_{steps:06}")
    eval_config = json.loads(json.dumps(config))
    eval_config["train_config"]["checkpoint_path"] = ckpt
    cfg = write_json("vit_small_fp32_eval.json", eval_config)
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        gts, preds, logits = eval_cli.main(["-c", cfg, "--device", "cuda"])
    launches_eval, ops_eval = read_counts()
    batches = math.ceil(len(gts) / tc["local_batch_size"])
    print(f"fp32: {os.path.basename(ckpt)} through the eval CLI: {len(gts)} "
          f"test images, accuracy {float(np.mean(gts == preds)):.4f}, op "
          f"launches {ops_eval}")
    check(bool(torch.isfinite(logits).all())
          and ops_eval["fused_attention_block"] == (depth * batches, 0)
          and not any(launches_eval[k] for k in BF16_CHAIN_KERNELS),
          f"fp32: eval launches {ops_eval}, {launches_eval}")

    # (b) MVT_NO_FUSE=1: the discrete Blocks, the fp32 flash kernels
    tc["output_directory"] = os.path.join(WORK, "fp32_nofuse_train")
    os.environ["MVT_NO_FUSE"] = "1"
    try:
        state, losses, launches, ops, took, run_dir = run_train_cli(
            config, "vit_small_fp32_nofuse_train", "fp32-nofuse")
        steps = state.iteration
        want = {"flash_attention_f32_fwd": K.F32_FLASH_FWD_LAUNCHES * depth
                * (n_accum * steps + val_batches),
                "flash_attention_f32_bwd":
                K.F32_FLASH_BWD_LAUNCHES * depth * n_accum * steps}
        got = {k: launches[k] for k in want}
        print(f"fp32-nofuse: ViT-S/16 train CLI under MVT_NO_FUSE=1, {steps} "
              f"steps in {took:.1f} s: fp32 flash launches {got}, expected "
              f"{want}; op launches {ops}; kernels "
              f"{ {k: v for k, v in launches.items() if v} }")
        check(got == want and not any(v != (0, 0) for v in ops.values())
              and not any(launches[k] for k in
                          BF16_CHAIN_KERNELS + F32_CHAIN_KERNELS),
              "fp32-nofuse: launches")
        for name in want:
            runs[name] = launches[name]
        first_step_check(model, train_loader,
                         os.path.join(run_dir, "vit_000000"), n_accum, micro,
                         losses[0], tag="fp32-nofuse")
    finally:
        del os.environ["MVT_NO_FUSE"]
    del model, train_loader, val_loader

    # (c) YOLOS-S in fp32: the 800 px forward, the 608 / 384 px steps
    det_config, _ = det_data
    ycfg = f32_config(yolos_small_config())
    ytc = ycfg["train_config"]
    ydepth = ycfg["vit_config"]["depth"]
    yolos = ViT(**vit_kwargs_from_config(ycfg, det_config), device=device,
                generator=torch.Generator().manual_seed(22))
    batch = forced_batch(det_config, 800, yolos.num_det_tokens, count=2)
    imgs = torch.from_numpy(batch["image"]).to(device)
    n_tok = tokens_of(*imgs.shape[1:3])
    yolos.eval()
    reset_counts()
    with torch.inference_mode():
        out = yolos(imgs)
        launched = read_counts()[0]["flash_attention_f32_fwd"]
        ref = yolos(imgs, plain=True)
    res = {k: f32_close(f"fp32: YOLOS-S 800 px {k}", out[k], ref[k],
                        F32_CHAIN_RTOL, F32_CHAIN_ATOL)
           for k in ("pred_logits", "pred_boxes")}
    print(f"fp32: YOLOS-S forward at 800 px ({n_tok} tokens, B=2), kernel vs "
          f"plain: " + ", ".join(f"{k} max_abs {m:.6g} ({s:.4f} of the fp32 "
                                 "chain bar)" for k, (m, s) in res.items())
          + f"; flash_attention_f32_fwd {launched} launches")
    check(n_tok == 2601 and launched == K.F32_FLASH_FWD_LAUNCHES * ydepth,
          f"fp32: the 800 px forward launched {launched}")
    runs["flash_attention_f32_fwd"] += launched
    yolos.train()
    steps = forced_step_check(
        yolos, det_config, det_config["number_of_classes"],
        build_weight_dict(ytc), ytc["eos_coef"], 2, 2, device,
        canvases=((608, "discrete, fp32 flash K6 / K7"),
                  (384, "fused, the long fp32 core")),
        expect=f32_step_launches, phase="fp32")
    for name in ("flash_attention_f32_fwd", "flash_attention_f32_bwd"):
        runs[name] += sum(s[name] for s in steps.values())
    check(steps[608]["flash_attention_f32_bwd"] > 0
          and steps[384]["attention_core_f32_bwd_long"] > 0
          and all(steps[384][k] > 0 for k in F32_CHAIN_KERNELS)
          and not any(steps[384][k] for k in BF16_CHAIN_KERNELS),
          "fp32: the YOLOS-S steps missed a route")
    print(f"fp32: phase took {time.perf_counter() - t_phase:.1f} s; "
          f"launches of the fp32 paths {runs}")
    return runs, ckpt, eval_config


def scalar_lines(offset):
    """The ``runs/scalars.jsonl`` lines the train CLIs appended past
    ``offset`` (their ScalarLogger's file without TensorBoard), or None
    where TensorBoard wrote event files instead."""
    path = os.path.join("runs", "scalars.jsonl")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return [json.loads(line) for line in f.readlines()[offset:]]


def phase_remainder(device, data_config, data_cfg, f32_ckpt, f32_config_,
                    scalar_offset):
    """(d) attention capture: the port's visualize_attention CLI on one
    test image from phase fp32's ViT-S/16 checkpoint (float32 compute) and
    from phase main's (bf16 compute): a PNG per head and the mean, each
    layer's probabilities (B, 6, 197, 197) in depth order with rows
    summing to 1, no kernel launched (every Block discrete, the xla core);
    (e) active dropout: the ViT-S/16 train CLI (bf16 compute) with dropout
    and emb_dropout 0.1 for 4 steps of 2 x 32: the Blocks discrete through
    the bf16 flash kernels (launches counted), no fused op in the steps,
    finite losses; (f) that run with MVT_PROFILE_DIR set leaves a Chrome
    trace with the card's kernels in it, and the detection and segmentation
    train CLIs of the earlier phases have logged their scalars."""
    from myrtle_vision_tpu_torch.classification import (
        visualize_attention as vis_cli,
    )

    t_phase = time.perf_counter()
    with open(os.path.join(data_config["dataset_path"],
                           data_config["test_files"])) as f:
        image = os.path.join(data_config["dataset_path"], f.read().split()[0])
    bf16_config = vit_small_config()
    bf16_config["data_config_path"] = data_cfg
    bf16_config["train_config"]["checkpoint_path"] = os.path.join(
        WORK, "vit_small_seed0.pth")
    for name, config in (("float32", f32_config_), ("bfloat16", bf16_config)):
        cfg = write_json(f"visualize_{name}.json", config)
        out_dir = os.path.join(WORK, f"attention_{name}")
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            cls_attn = vis_cli.main(["-c", cfg, "--image", image,
                                     "--output_dir", out_dir, "--device",
                                     "cuda"])
        launches, ops = read_counts()
        _, maps = vis_cli.attention_maps(config, image, device)
        pngs = sorted(os.listdir(out_dir))
        sums = np.concatenate([m.sum(-1).ravel() for m in maps])
        print(f"remainder: visualize_attention CLI ({name} compute) in "
              f"{time.perf_counter() - t0:.1f} s: {pngs}; {len(maps)} layers "
              f"of {maps[0].shape} probabilities, row sums within "
              f"{np.abs(sums - 1).max():.3g} of 1; CLS attention over the "
              f"patches {cls_attn.shape}; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        check(pngs == [f"layer-1_head{h}.png" for h in range(HEADS)]
              + ["layer-1_mean.png"], f"remainder: PNGs {pngs}")
        check(len(maps) == config["vit_config"]["depth"]
              and maps[0].shape == (HEADS, N, N)
              and np.abs(sums - 1).max() <= 1e-4
              and all(np.isfinite(m).all() for m in maps),
              "remainder: captured probabilities")
        check(not any(launches.values())
              and all(v == (0, 0) for v in ops.values()),
              f"remainder: the capture launched {launches}")

    # (e) active dropout, (f) the profiler over its steps 3-5
    config = vit_small_config()
    config["vit_config"].update(dropout=DROPOUT, emb_dropout=DROPOUT)
    depth = config["vit_config"]["depth"]
    tc = config["train_config"]
    tc.update(output_directory=os.path.join(WORK, "dropout_train"),
              checkpoint_path="", epochs=1, warmup_epochs=0,
              pretrained_backbone=None, iters_per_checkpoint=100,
              iters_per_val=100)
    config["data_config_path"] = subset_data_config(
        data_config, DROPOUT_TRAIN_IMAGES, "dropout")
    trace_dir = os.path.join(WORK, "profile")
    os.environ["MVT_PROFILE_DIR"] = trace_dir
    try:
        state, losses, launches, ops, took, _ = run_train_cli(
            config, "vit_small_dropout_train", "remainder")
    finally:
        del os.environ["MVT_PROFILE_DIR"]
    steps = state.iteration
    n_accum = tc["global_batch_size"] // tc["local_batch_size"]
    blocks = depth * n_accum * steps
    with open(os.path.join(data_config["dataset_path"],
                           data_config["valid_files"])) as f:
        val_images = len(f.read().split())
    val_batches = val_images // tc["local_batch_size"]  # drop_last_batch
    want = {"flash_attention_fwd": blocks, "flash_attention_bwd": 3 * blocks}
    got = {k: launches[k] for k in want}
    print(f"remainder: ViT-S/16 train CLI with dropout and emb_dropout "
          f"{DROPOUT}, {steps} steps in {took:.1f} s: bf16 flash launches "
          f"{got}, expected {want} (the discrete Blocks); op launches {ops} "
          f"(the validation's, eval without dropout: fused)")
    check(steps == DROPOUT_TRAIN_IMAGES // tc["global_batch_size"]
          and got == want
          and ops["fused_attention_block"] == (depth * val_batches, 0),
          "remainder: dropout launches")
    traces = sorted(os.listdir(trace_dir))
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"remainder: MVT_PROFILE_DIR trace {traces} of steps 3-5: "
          f"{len(events)} events, {kernels} of them the card's kernels")
    check(traces == ["trace_steps_3_5.json"] and kernels > 0,
          "remainder: the profiler's trace")

    lines = scalar_lines(scalar_offset)
    if lines is None:
        events = glob.glob(os.path.join("runs", "events.out.tfevents.*"))
        print(f"remainder: TensorBoard is installed: {len(events)} event "
              "files under runs/")
        check(len(events) > 0, "remainder: no scalars logged")
    else:
        tags = {}
        for row in lines:
            if "tag" in row:
                tags.setdefault(row["tag"], []).append(row["value"])
        print(f"remainder: scalars.jsonl of the detection and segmentation "
              f"train CLIs: {len(lines)} lines, "
              + ", ".join(f"{t} x{len(v)}" for t, v in sorted(tags.items())))
        check(all(t in tags for t in ("lr", "val_AP", "accuracy", "loss",
                                      "miou"))
              and all(math.isfinite(v) for vs in tags.values() for v in vs),
              f"remainder: scalars {sorted(tags)}")
    print(f"remainder: phase took {time.perf_counter() - t_phase:.1f} s")


def f32_chain_cost(name, b, n, leaves, library):
    """The bound of one fp32 block-half chain call at (B, N) ViT-S/16
    widths, worked out as the float formats' rows are: its products at
    three bf16 passes on the tensor cores (the card's fastest way to fp32
    products), its inputs read and outputs written once."""
    m, d = b * n, C // HEADS
    att = 4 * b * HEADS * n * n * d  # S = q k^T and P V
    flops = {"K1 fp32": 2 * m * C * 4 * C + att,
             "K2 fp32": 2 * m * C * 8 * C + 2.5 * att,
             "K3 fp32": 4 * m * C * HID,
             "K4 fp32": 10 * m * C * HID}[name]
    return cost(nbytes(*leaves), 3 * flops, "bf16", library)


def f32_flash_share(name, c, timed, split_bytes, library, power):
    """One line for an fp32 flash case (``c``: its cost, ``timed``:
    time_case's result): the kernel's and its device time as shares of the
    bound (three bf16 passes of its products at 989 TFLOP/s, as for the
    fp32 chains: what the card needs for products this close to fp32), of
    the 3xTF32 bound (three TF32 passes at 495 TFLOP/s: this design's own
    products), the split pass's bytes (``split_bytes``, read once and
    written once) at the memory rate, and the yardstick's time from the
    same run."""
    b_ms, lib_ms, _, k_ms, dev_ms = timed
    t_ms = bound(dict(c, peak="tf32"))[0]
    s_ms = bound(cost(split_bytes, 0, "bf16"))[0]
    dev = ("device not measured" if dev_ms is None
           else f"device {dev_ms:.4f} ms, {b_ms / dev_ms:.3f} of the bound")
    print(f"timing: {name} bound {b_ms:.4f} ms (three bf16 passes at 989 "
          f"TFLOP/s): kernel {k_ms:.4f} ms, {b_ms / k_ms:.3f} of the bound; "
          f"{dev}; 3xTF32 bound {t_ms:.4f} ms (three TF32 passes at 495 "
          f"TFLOP/s), kernel {t_ms / k_ms:.3f} of it; split pass's bytes "
          f"{split_bytes} at 3.35 TB/s {s_ms:.4f} ms; {library} "
          f"{lib_ms:.4f} ms, kernel / {library} {k_ms / lib_ms:.3f} [{power}]")


def f32_split_bytes(b, h, n, d, reads, arrays):
    """The bytes of the fp32 flash split pass: ``reads`` fp32 (B, H, N, D)
    operands read once, ``arrays`` layouts written, a hi and a lo half of
    (B H, N rounded up to 8, D) each."""
    return 4 * b * h * d * (reads * n + 2 * arrays * (-(-n // 8) * 8))


def time_f32(device, power):
    """Per call at the fp32 paths' shapes: the fp32 flash forward at K6's
    (8, 6, 2601, 64) and K5's (256, 6, 197, 64), the backward at K7's
    (8, 6, 1545, 64) and K8's (256, 6, 197, 64), each beside its plain
    version, its bound (three bf16 passes of its products at 989 TFLOP/s),
    its share of that bound and of the 3xTF32 bound, the split pass's bytes
    and fp32 SDPA (its backward by autograd); the fp32
    K1-K4 route per ViT-S/16 block at B=256 beside the plain chains and
    F.layer_norm, cuBLAS fp32 products and fp32 SDPA; then the ViT-S/16
    fp32 step at B=256, fused and under MVT_NO_FUSE=1, the YOLOS-S fp32
    800 px forward (B=8) and its train step at 608 and 384 px, with device
    profiles.  Returns the kernels line's totals."""
    import torch.nn.functional as F

    from myrtle_vision_tpu_torch.models.vit import ViT
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops import fused_attention_block as fa
    from myrtle_vision_tpu_torch.ops import fused_mlp as fm
    from myrtle_vision_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_plain,
        flash_attention_plain,
    )
    from myrtle_vision_tpu_torch.training.classification import make_loss_fn
    from myrtle_vision_tpu_torch.training.optim import create_optimizer
    from myrtle_vision_tpu_torch.training.trainer import (
        TrainState,
        make_train_step,
    )

    totals = {}
    for b, h, n, d, tag in ((8, 6, 2601, 64, "K6 regime, 800 px"),
                            (256, 6, N, 64, "K5 regime, ViT-S/16")):
        q, k, v = f32_views(b, n, h, d, 25000 + n, device)
        sc = d ** -0.5
        c = cost(nbytes(q, k, v, q), 3 * 4 * b * h * n * n * d, "bf16",
                 lambda: F.scaled_dot_product_attention(q, k, v, scale=sc))
        f32_flash_share(f"flash_attention_f32_fwd[{tag}]", c, time_case(
            totals, f"flash_attention_f32_fwd[{tag}]",
            lambda: K.flash_attention_f32_fwd_cuda(q, k, v, sc),
            lambda: flash_attention_plain(q, k, v, sc),
            1 if tag.startswith("K6") else 0, c, power,
            f"B={b} H={h} N={n} D={d}"), f32_split_bytes(b, h, n, d, 2, 2),
            "fp32 SDPA", power)
        del q, k, v
    for b, h, n, d, tag in ((8, 6, 1545, 64, "K7 regime, 608 px"),
                            (256, 6, N, 64, "K8 regime, ViT-S/16")):
        q, k, v = f32_views(b, n, h, d, 26000 + n, device)
        do = seeded(np.random.RandomState(n), (b, h, n, d), 1.0, device)
        sc = d ** -0.5
        o, lse = K.flash_attention_f32_fwd_cuda(q, k, v, sc, lse=True)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        ref_out = F.scaled_dot_product_attention(*leaves, scale=sc)
        c = cost(nbytes(q, k, v, o, do) * 8 // 5 + nbytes(lse),
                 3 * 10 * b * h * n * n * d, "bf16",
                 lambda: torch.autograd.grad(ref_out, leaves, do,
                                             retain_graph=True))
        f32_flash_share(f"flash_attention_f32_bwd[{tag}]", c, time_case(
            totals, f"flash_attention_f32_bwd[{tag}]",
            lambda: K.flash_attention_f32_bwd_cuda(q, k, v, o, do, lse, sc),
            lambda: flash_attention_bwd_plain(q, k, v, o, do, lse, sc),
            1 if tag.startswith("K7") else 0, c, power,
            f"B={b} H={h} N={n} D={d}"), f32_split_bytes(b, h, n, d, 4, 7),
            "fp32 SDPA's backward", power)
        del q, k, v, do, o, lse, leaves, ref_out

    # the fp32 K1-K4 route, per ViT-S/16 block at B=256
    b = 256
    x, attn, mlp, do = block_inputs(b, N, 27000, device, C, HID)
    x, do = x.float(), do.float()

    def ref_attn(x, s, bi, wqkv, bqkv, wp, bp):
        xn = F.layer_norm(x, (C,), s, bi)
        qkv = (xn @ wqkv + bqkv).view(b, N, 3, HEADS, -1)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, scale=SCALE)
        return x + o.transpose(1, 2).reshape(b, N, C) @ wp + bp

    def ref_mlp(x, s, bi, w1, b1, w2, b2):
        xn = F.layer_norm(x, (C,), s, bi)
        return x + F.gelu(xn @ w1 + b1) @ w2 + b2

    for op, plain, ref, params, extra, tpu in (
            (fa.fused_attention_block, fa.fused_attention_block_plain,
             ref_attn, attn, (HEADS, SCALE), "K1 fp32"),
            (fm.fused_mlp_block, fm.fused_mlp_block_plain, ref_mlp, mlp, (),
             "K3 fp32")):
        name = [k for k, v in F32_ROUTE.items() if v[2] == tpu][0]
        with torch.no_grad():
            out = op(x, *params, *extra)
        totals[tpu] = route_case(
            name, lambda: op(x, *params, *extra),
            lambda: plain(x, *params, *extra),
            f32_chain_cost(tpu, b, N, (x, *params, out),
                           lambda: ref(x, *params)), power)
        leaves = [t.detach().clone().requires_grad_() for t in (x, *params)]
        plain_leaves = [t.detach().clone().requires_grad_()
                        for t in (x, *params)]
        ref_leaves = [t.detach().clone().requires_grad_()
                      for t in (x, *params)]
        k_out = op(*leaves, *extra)
        p_out = plain(*plain_leaves, *extra)
        r_out = ref(*ref_leaves)
        bwd_tpu = "K2 fp32" if tpu == "K1 fp32" else "K4 fp32"
        totals[bwd_tpu] = route_case(
            name.replace("]", ",bwd]"),
            lambda: torch.autograd.grad(k_out, leaves, do, retain_graph=True),
            lambda: torch.autograd.grad(p_out, plain_leaves, do,
                                        retain_graph=True),
            f32_chain_cost(bwd_tpu, b, N, (x, do, x, *params, *params),
                           lambda: torch.autograd.grad(
                               r_out, ref_leaves, do, retain_graph=True)),
            power)
        del leaves, plain_leaves, ref_leaves, k_out, p_out, r_out
    del x, attn, mlp, do

    # the paths: ViT-S/16 fp32 step at B=256, fused and MVT_NO_FUSE=1
    groups = {"flash fp32": ("flash_f32_",),
              "fp32 chain": ("gemm_f32x3", "layernorm_snap",
                             "attention_core_f32", "f32_long")}
    config = f32_config(vit_small_config())
    vc = config["vit_config"]
    model = ViT("classification", vc["image_size"], vc["patch_size"], 45,
                vc["embed_dim"], vc["depth"], vc["heads"], vc["mlp_dim"],
                dim_head=vc["embed_dim"] // vc["heads"],
                compute_dtype=torch.float32, device=device)
    state = TrainState(model, create_optimizer(config["train_config"], model))
    gen = torch.Generator(device).manual_seed(2)
    batch = {"image": torch.randn(1, b, 224, 224, 3, device=device,
                                  generator=gen),
             "label": torch.randint(0, 45, (1, b), device=device,
                                    generator=gen)}
    step = make_train_step(make_loss_fn(model), 1)
    for mode in ("fused", "MVT_NO_FUSE=1"):
        if mode != "fused":
            os.environ["MVT_NO_FUSE"] = "1"
        try:
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step(state, batch, 1e-4), iters=5, warmup=2)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            line = device_profile(lambda: step(state, batch, 1e-4), groups)
        finally:
            os.environ.pop("MVT_NO_FUSE", None)
        print(f"timing: ViT-S/16 float32-compute train step ({mode}) at "
              f"B={b}: {ms:.3f} ms = {b / ms * 1e3:.1f} img/s, peak "
              f"{peak:.2f} GiB; profile: {line} [{power}]")
    del model, state, batch, step

    yolos = ViT("detection", 224, 16, 20, 384, 12, 6, 1536,
                compute_dtype=torch.float32, device=device)
    time_yolos_forward(yolos, "float32-compute ", groups, device, power)
    time_yolos_step(yolos, "float32-compute ", groups, device, power)
    return totals


def route_case(name, kernel, plain, c, power):
    """One fp32 route chain per ViT-S/16 block at B=256: paired kernel and
    plain ms, the profiler's device time, the yardstick's ms, the bound;
    {ms, plain_ms, bound_ms, bound_by, library_ms, device_ms}."""
    k_ms, p_ms = paired_ms(kernel, plain, iters=10)
    lib_ms = cuda_ms(c["library"], iters=10)
    b_ms, by = bound(c)
    dev_ms, _, miss = kernel_device_ms(kernel, iters=10)
    reset_counts()
    kernel()
    launches = {k: v for k, v in read_counts()[0].items() if v}
    device = (f"device not measured ({miss})" if dev_ms is None
              else f"device {dev_ms:.4f} ms")
    print(f"timing: {name} per ViT-S/16 block at B=256 kernel chain "
          f"{k_ms:.4f} ms ({device}) plain {p_ms:.4f} ms, yardstick "
          f"(F.layer_norm, cuBLAS fp32 products, fp32 SDPA or F.gelu) "
          f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}: {c['bytes']} bytes, "
          f"{c['ops']:.4g} bf16 ops as three passes); launches {launches} "
          f"[{power}]")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms, "device_ms": dev_ms}


def port_kernel_names():
    """The names of the port's own CUDA kernels: every ``__global__``
    function under csrc/."""
    names = set()
    for path in glob.glob(os.path.join(ROOT, CSRC, "*.cu*")):
        with open(path) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\((?:[^()]|"
                r"\([^()]*\))*\)\s*)?(\w+)\s*\(", f.read()))
    return names


def device_profile(run, named):
    """Device ms by kernel group of one call of ``run`` (``named``: group
    -> substrings of its kernels' names; then the port's other kernels,
    matched by their names in csrc/ so that none is taken for a library
    kernel; then cuBLAS products and everything else), the device's busy
    ms (the union of its kernel intervals) over the window from the first
    kernel's start to the last one's end, and the idle share of that
    window."""
    from torch.profiler import ProfilerActivity, profile

    # a name as the profiler shows it, demangled (`ns::name<...>(`) or
    # not (`<length>name` then `I` or `E`)
    own = re.compile(r"(?:^|[\s:\d])(?:" + "|".join(
        sorted(port_kernel_names())) + r")[<(IE]")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return "no device events (not measured)"
    groups = {**{k: 0.0 for k in named}, "other port kernels": 0.0,
              "cuBLAS products": 0.0, "other": 0.0}
    busy, end = 0.0, spans[0][0]
    for start, stop, name in spans:
        key = next((k for k, subs in named.items()
                    if any(t in name for t in subs)), None)
        if key is None and own.search(name):
            key = "other port kernels"
        if key is None:
            key = ("cuBLAS products" if any(
                t in name.lower() for t in ("gemm", "cutlass", "xmma",
                                            "sm90_")) else "other")
        groups[key] += stop - start
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    window = end - spans[0][0]
    return ("device ms by group "
            + ", ".join(f"{k} {v / 1e3:.3f}" for k, v in groups.items())
            + f"; busy {busy / 1e3:.3f} of a {window / 1e3:.3f} ms window, "
            f"idle share {1 - busy / window:.4f}; {len(spans)} kernels")


# ---------------------------------------------------------------- multigpu
# Multi-GPU training on the one card: the res_scale forms of K1-K4 (the
# kernels of head-sharded tensor parallelism) against their plain
# versions at ViT-S/16's local widths at n_tp = 2, the data-parallel step
# over a real NCCL group of one against the step without a group, and
# two ranks of the train CLIs over gloo (NCCL refuses two ranks on one
# GPU), each launched as a user launches a rank, against one process.
MG_C, MG_CL, MG_HID, MG_HEADS = 384, 192, 768, 3
MG_RES_SCALE = 0.5
MG_TRAIN_IMAGES = 128   # two steps of 64 images
MG_NCCL_STEPS = 3
MG_DET_SUBSET, MG_DET_VALID, MG_DET_PX = 8, 4, 384
MG_TIMEOUT_S = 300
MG_SHARED = "two ranks share one card: not a scaling figure"
TPU_K1_RES = "myrtle_vision_tpu/ops/fused_attention_block.py:231"
TPU_K3_RES = "myrtle_vision_tpu/ops/fused_mlp.py:188"
TPU_K2_RES = "myrtle_vision_tpu/ops/fused_attention_block.py:525"
TPU_K4_RES = "myrtle_vision_tpu/ops/fused_mlp.py:307"
RES_SCALE_KERNELS = {
    "gemm_bf16_epilogue[res_scale]": (
        "gemm_bf16_epilogue", CSRC + "gemm_bf16_wgmma.cu",
        f"{TPU_K1_RES}; {TPU_K3_RES}"),
    "gemm_f32x3_epilogue[res_scale]": (
        "gemm_f32x3_epilogue", CSRC + "gemm_f32x3_wgmma.cu",
        f"{TPU_K1_RES}; {TPU_K3_RES} (fp32 activations)"),
    "layernorm_rows_bwd[res_scale]": (
        "layernorm_rows_bwd", CSRC + "layernorm_rows_bwd.cu",
        f"{TPU_K2_RES}; {TPU_K4_RES}"),
    "layernorm_snap_rows_bwd[res_scale]": (
        "layernorm_snap_rows_bwd", CSRC + "layernorm_rows_bwd.cu",
        f"{TPU_K2_RES}; {TPU_K4_RES} (fp32 activations)"),
}


def mg_local_block(b, n, seed, device, dtype):
    """x (B, N, C) and one model rank's local weights at n_tp = 2, each
    the (in, out) view of a row-major torch weight as the Block's tensor
    parallel branch hands them over: the attention half's (C, 3 cl) and
    (cl, C), the MLP half's (C, H/2) and (H/2, C); the output biases as
    the Block scales them."""
    rng = np.random.RandomState(seed)
    c, cl, hid = MG_C, MG_CL, MG_HID
    x = seeded(rng, (b, n, c), 1.0, device, dtype)

    def ln():
        return [1 + seeded(rng, (c,), 0.1, device),
                seeded(rng, (c,), 0.1, device)]

    attn = ln() + [seeded(rng, (3 * cl, c), c ** -0.5, device).t(),
                   seeded(rng, (3 * cl,), 1.0, device),
                   seeded(rng, (c, cl), cl ** -0.5, device).t(),
                   seeded(rng, (c,), 1.0, device) * MG_RES_SCALE]
    mlp = ln() + [seeded(rng, (hid, c), c ** -0.5, device).t(),
                  seeded(rng, (hid,), 1.0, device),
                  seeded(rng, (c, hid), hid ** -0.5, device).t(),
                  seeded(rng, (c,), 1.0, device) * MG_RES_SCALE]
    return x, attn, mlp


def mg_kernel_cases(device):
    """The res_scale forms at B=64, N=197 on the operands the chains hand
    them: (name, kernel, plain, bar kinds, launches per block, cost)."""
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops.fake_quant import kernel_sites
    from myrtle_vision_tpu_torch.ops.fused_attention_block import (
        no_snap_sites,
    )
    from myrtle_vision_tpu_torch.ops.high_precision import split_bf16

    rng = np.random.RandomState(41)
    b, n, c = 64, N, MG_C
    rows, s = b * n, MG_RES_SCALE
    bf = torch.bfloat16
    cases = []
    for label, k in (("out proj", MG_CL), ("fc2", MG_HID)):
        a = seeded(rng, (rows, k), 1.0, device, bf)
        w = seeded(rng, (c, k), k ** -0.5, device, bf).t()
        bias = seeded(rng, (c,), 1.0, device)
        res = seeded(rng, (rows, c), 1.0, device, bf)
        cases.append((
            f"gemm_bf16_epilogue[res_scale] {label}",
            functools.partial(K.gemm_bf16_epilogue_cuda, a, w, bias,
                              "bias_residual", res, res_scale=s),
            functools.partial(K.gemm_bf16_epilogue_plain, a, w, bias,
                              "bias_residual", res, res_scale=s),
            ("kernel",), 1,
            cost(nbytes(a, w, bias, res) + 2 * rows * c, 2 * rows * c * k,
                 "bf16", functools.partial(torch.addmm, res, a, w, beta=s))))
        a32, w32 = a.float(), seeded(rng, (c, k), k ** -0.5, device).t()
        r32 = res.float()
        sites = kernel_sites(no_snap_sites(device), 3, 4)
        ah, al = (t.to(bf) for t in split_bf16(a32))
        wh, wl = (t.to(bf) for t in split_bf16(w32))
        cases.append((
            f"gemm_f32x3_epilogue[res_scale] {label}",
            functools.partial(K.gemm_f32x3_epilogue_cuda, a32, w32, bias,
                              "bias_snap_residual_snap", sites, r32,
                              res_scale=s),
            functools.partial(K.gemm_f32x3_epilogue_plain, a32, w32, bias,
                              "bias_snap_residual_snap", sites, r32,
                              res_scale=s),
            ("f32",), 1,
            cost(nbytes(a32, w32, bias, r32) + 4 * rows * c,
                 3 * 2 * rows * c * k, "bf16",
                 lambda ah=ah, wh=wh, wl=wl, al=al: (
                     torch.matmul(ah, wh), torch.matmul(ah, wl),
                     torch.matmul(al, wh)))))
    x2 = seeded(rng, (rows, c), 1.0, device, bf)
    sc = 1 + seeded(rng, (c,), 0.1, device, bf)
    dxn = seeded(rng, (rows, c), 1.0, device)
    do2 = seeded(rng, (rows, c), 1.0, device, bf)
    mean = x2.float().mean(-1, keepdim=True)
    rstd = torch.rsqrt(x2.float().var(-1, unbiased=False, keepdim=True)
                       + K.EPS)
    yard = functools.partial(
        torch.ops.aten.native_layer_norm_backward, dxn.to(bf), x2, [c],
        mean, rstd, sc, torch.zeros_like(sc), [True, True, True])
    cases.append((
        "layernorm_rows_bwd[res_scale]",
        functools.partial(K.layernorm_rows_bwd_cuda, x2, sc, dxn, do2,
                          res_scale=s),
        functools.partial(K.layernorm_rows_bwd_plain, x2, sc, dxn, do2,
                          res_scale=s),
        ("kernel", "sum", "sum"), 2,
        cost(nbytes(x2, sc, dxn, do2, x2) + 8 * c, 12 * x2.numel(), "fp32",
             yard)))
    snap = kernel_sites(no_snap_sites(device))
    x32, s32, do32 = x2.float(), sc.float(), do2.float()
    cases.append((
        "layernorm_snap_rows_bwd[res_scale]",
        functools.partial(K.layernorm_rows_bwd_cuda, x32, s32, dxn, do32,
                          snap, res_scale=s),
        functools.partial(K.layernorm_rows_bwd_plain, x32, s32, dxn, do32,
                          snap, res_scale=s),
        ("f32", "f32sum", "f32sum"), 2,
        cost(nbytes(x32, s32, dxn, do32, x32) + 8 * c, 12 * x32.numel(),
             "fp32", yard)))
    return cases


def mg_compare(label, got, ref, kind):
    if kind == "f32":
        return f32_close(label, got, ref, F32_CHAIN_RTOL, F32_CHAIN_ATOL)
    if kind == "f32sum":
        return f32_close(label, got, ref, F32_CHAIN_RTOL,
                         F32_CHAIN_SUM_ATOL)
    return compare(label, got, ref, *bar(kind, ref))


def phase_multigpu_kernels(device, power):
    """The res_scale kernels against their plain versions, then both
    block halves' chains (bf16 and fp32 compute, forward and backward)
    at the local widths; the kernels timed at B=64.  Returns ({kernel
    name: largest error}, {kernel name: timing totals per block})."""
    from myrtle_vision_tpu_torch.ops.fused_attention_block import (
        fused_attention_block,
        fused_attention_block_plain,
    )
    from myrtle_vision_tpu_torch.ops.fused_mlp import (
        fused_mlp_block,
        fused_mlp_block_plain,
    )

    errors = dict.fromkeys(RES_SCALE_KERNELS, 0.0)
    totals = {}
    for name, kernel, plain, kinds, count, c in mg_kernel_cases(device):
        key = name.split(" ")[0]
        for i, (got, ref, kind) in enumerate(zip(
                as_tuple(kernel()), as_tuple(plain()), kinds)):
            max_abs, of_bar = mg_compare(f"{name}[{i}]", got, ref, kind)
            errors[key] = max(errors[key], max_abs)
            print(f"kernels: {name} output {i} res_scale {MG_RES_SCALE} "
                  f"B=64 N={N}: max_abs {max_abs:.6g}, {of_bar:.3g} of "
                  f"its bar")
        time_case(totals, name, kernel, plain, count, c, power,
                  f"B=64,N={N},C={MG_C},local")
    scale = (MG_CL // MG_HEADS) ** -0.5
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        x, attn, mlp = mg_local_block(64, N, 5, device, dtype)
        do = seeded(np.random.RandomState(6), x.shape, 1.0, device, dtype)
        for op, plain, params, extra in (
                (fused_attention_block, fused_attention_block_plain, attn,
                 (MG_HEADS, scale, None, None, MG_RES_SCALE)),
                (fused_mlp_block, fused_mlp_block_plain, mlp,
                 (None, MG_RES_SCALE))):
            label = f"{op.__name__}[res_scale,{tag}]"
            got, ref = op(x, *params, *extra), plain(x, *params, *extra)
            fwd = (mg_compare(label, got, ref, "f32") if tag == "fp32"
                   else compare(label, got, ref, *bar("chain", ref)))
            g_got = leaf_grads(op, x, params, extra, do)
            g_ref = leaf_grads(plain, x, params, extra, do)
            worst = 0.0
            for i, (g, r) in enumerate(zip(g_got, g_ref)):
                kind = (("f32" if i == 0 else "f32sum") if tag == "fp32"
                        else ("chain" if i == 0 else "sum"))
                worst = max(worst, mg_compare(f"{label}[bwd {i}]", g, r,
                                              kind)[1])
            print(f"kernels: {label} B=64 N={N} local heads "
                  f"{MG_HEADS} x 64, hidden {MG_HID}: "
                  f"forward max_abs {fwd[0]:.6g} ({fwd[1]:.3g} of its bar), "
                  f"backward worst {worst:.3g} of its bar")
    return errors, totals


def mg_first_step_hook(cli, grads_path, times):
    """Wrap ``cli.create_optimizer`` so that the optimizer's first step
    writes the gradients it applies to ``grads_path`` (fp32, on the
    host, by parameter name) and the INT8 observers to ``grads_path`` +
    ".observers.pt", and every step appends its host time (after a
    synchronize) to ``times``; what the CLI computes is unchanged."""
    real = cli.create_optimizer

    def create(train_config, model):
        optimizer = real(train_config, model)
        names = {id(p): n for n, p in model.named_parameters()}
        step = optimizer.step

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            times.append(time.perf_counter())
            if len(times) == 1 and grads_path:
                torch.save({names[id(p)]: p.grad.detach().float().cpu()
                            for g in optimizer.param_groups
                            for p in g["params"] if p.grad is not None},
                           grads_path)
                # the INT8 observers after the first step's passes
                torch.save({n: b.detach().float().cpu()
                            for n, b in model.state_dict().items()
                            if n.endswith((".min", ".max"))},
                           grads_path + ".observers.pt")
            return step(*args, **kwargs)

        optimizer.step = wrapped
        return optimizer

    cli.create_optimizer = create
    return real


def counted_cli(module, argv, out_json=None, grads_path=None):
    """Run ``module``'s ``main(argv)`` (a train CLI) with the launch
    counts reset before and read after, the first step's gradients
    written to ``grads_path``; returns (its stdout, the counts: kernel
    launches, res_scale launches, op launches, the optimizer steps' host
    times, the discrete Blocks' attention calls by head count), also
    written to ``out_json``."""
    import importlib

    from myrtle_vision_tpu_torch.ops import _kernels as K

    from myrtle_vision_tpu_torch.models import vit

    cli = importlib.import_module(module)
    times = []
    real = mg_first_step_hook(cli, grads_path, times)
    out = io.StringIO()
    heads, core = [], vit._attention

    def record(q, *args, **kwargs):
        heads.append(q.shape[1])
        return core(q, *args, **kwargs)

    reset_counts()
    vit._attention = record
    try:
        with contextlib.redirect_stdout(out):
            cli.main(argv)
        launches, ops = read_counts()
    finally:
        cli.create_optimizer = real
        vit._attention = core
    counts = {"launches": launches, "res_scale": dict(K.RES_SCALE_LAUNCHES),
              "ops": ops, "times": times,
              "heads": {str(h): heads.count(h) for h in sorted(set(heads))}}
    if out_json:
        with open(out_json, "w") as f:
            json.dump(counts, f)
    return out.getvalue(), counts


def mg_launch(tag, module, cfg):
    """Two ranks of ``module`` (a train CLI) on the card over gloo, each
    a process launched as a user launches one rank (MVT_COORDINATOR,
    MVT_NUM_PROCESSES, MVT_PROCESS_ID), through this script's
    ``--counted`` mode; each waited for with a timeout, every one killed
    past it.  Returns [(stdout, counts)] by rank and the seconds."""
    from myrtle_vision_tpu_torch.parallel.launch import free_port

    port = free_port()
    procs, paths = [], []
    t0 = time.perf_counter()
    for rank in range(2):
        paths.append(os.path.join(WORK, f"mg_{tag}_rank{rank}"))
        env = dict(os.environ, MVT_COORDINATOR=f"localhost:{port}",
                   MVT_NUM_PROCESSES="2", MVT_PROCESS_ID=str(rank),
                   MVT_DIST_TIMEOUT="120")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--counted",
             paths[-1] + ".json", paths[-1] + "_grads.pt", module, "-c",
             cfg, "--device", "cuda"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=MG_TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    took = time.perf_counter() - t0
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        check(proc.returncode == 0,
              f"multigpu {tag}: rank {rank} exited {proc.returncode}:\n"
              f"{out[-4000:]}")
    runs = []
    for path, out in zip(paths, outs):
        with open(path + ".json") as f:
            runs.append((out, json.load(f)))
    return runs, took


def mg_losses(text, detection=False):
    if detection:
        return [[float(v) for v in m] for m in re.findall(
            r"Iteration \d+:\tloss=(\S+)\tce=(\S+)\tbbox=(\S+)\tgiou=(\S+)",
            text)]
    return [float(v) for v in
            re.findall(r"Iteration \d+:\tloss=(\S+)\tacc=", text)]


def mg_grad_error(got_path, ref_path):
    """(largest relative gradient error over the tensors, its name)."""
    got = torch.load(got_path, weights_only=True)
    ref = torch.load(ref_path, weights_only=True)
    check(set(got) == set(ref), "multigpu: gradient names differ")
    worst, name = 0.0, ""
    for n, r in ref.items():
        check(bool(torch.isfinite(got[n]).all()), f"non-finite grad {n}")
        rel = ((got[n] - r).norm() / r.norm().clamp_min(1e-30)).item()
        if rel > worst:
            worst, name = rel, n
    return worst, name


def mg_step_ms(times):
    """Host ms between optimizer steps after the first (a synchronize
    before each)."""
    d = np.diff(times[1:]) if len(times) > 2 else np.diff(times)
    return float(np.mean(d)) * 1e3 if len(d) else float("nan")


def mg_classification(tag, config, ref_config, power, expect_res=None,
                      also=None):
    """Two ranks of the classification train CLI on ``config`` against
    one process on ``ref_config`` (the same steps at equal n_accum): the
    first step's loss (LOSS_BAR) and gradients (GRAD_BAR), the later
    steps' spread; ``expect_res``, the res_scale launches rank 0 must
    count; ``also(tag, rank 0's counts, rank 1's, the one process's)``
    checks more.  Returns rank 0's counts."""
    ref_cfg = write_json(f"mg_{tag}_one.json", ref_config)
    ref_grads = os.path.join(WORK, f"mg_{tag}_one_grads.pt")
    text, ref_counts = counted_cli(
        "myrtle_vision_tpu_torch.classification.train",
        ["-c", ref_cfg, "--device", "cuda"], grads_path=ref_grads)
    ref = mg_losses(text)
    cfg = write_json(f"mg_{tag}.json", config)
    torch.cuda.empty_cache()
    runs, took = mg_launch(tag, "myrtle_vision_tpu_torch.classification.train",
                           cfg)
    (out0, counts0), (out1, counts1) = runs
    got = mg_losses(out0)
    check(len(got) == len(ref) >= 1 and not mg_losses(out1),
          f"multigpu {tag}: iteration lines {got} (rank 1: "
          f"{mg_losses(out1)}), one process {ref}")
    layout = re.search(r"ranks: .*", out0).group(0)
    worst, name = mg_grad_error(
        os.path.join(WORK, f"mg_{tag}_rank0_grads.pt"), ref_grads)
    diff = abs(got[0] - ref[0])
    spread = max(abs(a - b) for a, b in zip(got, ref))
    print(f"multigpu: {tag}: {layout}; losses {got} against one process "
          f"{ref}: first step |d| {diff:.3g} (bar "
          f"{LOSS_BAR * max(1.0, abs(ref[0])):.3g}), largest relative "
          f"first-step gradient error {worst:.4g} in {name} (bar "
          f"{GRAD_BAR:g}), later steps' spread {spread:.3g}; {took:.1f} s "
          f"for both ranks")
    print(f"multigpu: {tag}: rank 0 res_scale launches "
          f"{counts0['res_scale']}, block-half ops {counts0['ops']}")
    print(f"timing: multigpu {tag} step {mg_step_ms(counts0['times']):.3f} "
          f"ms a rank (host clock between optimizer steps), one process "
          f"{mg_step_ms(ref_counts['times']):.3f} ms; {MG_SHARED} "
          f"[{power}]")
    check(diff <= LOSS_BAR * max(1.0, abs(ref[0])),
          f"multigpu {tag}: first-step loss")
    check(worst <= GRAD_BAR, f"multigpu {tag}: first-step gradients")
    if expect_res is not None:
        check(counts0["res_scale"] == counts1["res_scale"] == expect_res,
              f"multigpu {tag}: res_scale launches {counts0['res_scale']} "
              f"/ {counts1['res_scale']}, expected {expect_res}")
    if also is not None:
        also(tag, counts0, counts1, ref_counts)
    return counts0


def mg_nccl(device, power, config):
    """The trainer's data-parallel step over a real NCCL group of one
    (DistributedDataParallel over it) against the step without a group:
    MG_NCCL_STEPS steps of 64 images from one initial state on the same
    batches; the largest difference in loss and parameters (zero is
    expected), then both steps timed."""
    import torch.distributed as dist

    from myrtle_vision_tpu_torch.classification import train as train_cli
    from myrtle_vision_tpu_torch.parallel.launch import free_port
    from myrtle_vision_tpu_torch.parallel.mesh import Mesh
    from myrtle_vision_tpu_torch.training.classification import make_loss_fn
    from myrtle_vision_tpu_torch.training.optim import create_optimizer
    from myrtle_vision_tpu_torch.training.trainer import (
        TrainState,
        data_parallel,
        make_train_step,
    )

    tc = config["train_config"]

    def setup():
        with contextlib.redirect_stdout(io.StringIO()):
            model, loader, _, (micro, n_accum) = train_cli.build_train(
                config, device)
        batches = []
        for batch in loader.epoch(0):
            batches.append({k: v.view(n_accum, micro, *v.shape[1:])
                            for k, v in batch.items()})
            if len(batches) == MG_NCCL_STEPS:
                break
        return model, batches, n_accum

    def run(mesh):
        model, batches, n_accum = setup()
        module = data_parallel(model, mesh)
        state = TrainState(model, create_optimizer(tc, model))
        step = make_train_step(make_loss_fn(module), n_accum, mesh=mesh,
                               module=module)
        losses = [float(step(state, b, tc["lr"])["loss"]) for b in batches]
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        ms = cuda_ms(lambda: step(state, batches[0], tc["lr"]), iters=5,
                     warmup=2)
        return losses, params, ms, type(module).__name__

    plain_losses, plain_params, plain_ms, _ = run(None)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = Mesh(data_group=dist.group.WORLD)
        losses, params, ms, wrapper = run(mesh)
        backend = dist.get_backend()
    finally:
        dist.destroy_process_group()
    d_loss = max(abs(a - b) for a, b in zip(losses, plain_losses))
    d_param, worst = max(((params[n] - p).abs().max().item(), n)
                         for n, p in plain_params.items())
    print(f"multigpu: nccl, one rank: {wrapper} over a {backend} group of "
          f"1, {MG_NCCL_STEPS} steps of 64 images (vit_small.json, full "
          f"width): losses {losses} against {plain_losses} without a "
          f"group; largest difference: loss {d_loss:.6g}, parameters "
          f"{d_param:.6g} in {worst} (zero expected)")
    print(f"timing: multigpu one-rank DDP step {ms:.3f} ms, undistributed "
          f"{plain_ms:.3f} ms, difference {ms - plain_ms:+.3f} ms (CUDA "
          f"events, 64 images a step) [{power}]")
    check(backend == "nccl" and wrapper == "DataParallel",
          f"nccl run: {backend}, {wrapper}")
    check(d_loss <= LOSS_BAR * max(1.0, abs(plain_losses[0])),
          "nccl one-rank step: loss")
    check(d_param <= 2.0 ** -10, "nccl one-rank step: parameters")


def mg_detection(power, det_data_config):
    """Two data ranks of the YOLOS-S detection train CLI at 384 px, 2
    steps of 2 images a rank, against one process at 4 images a step (the
    same n_accum): the box losses, which num_boxes normalises, of the
    first step at LOSS_BAR, with the ranks' unequal box counts printed;
    the later step's spread."""
    from myrtle_vision_tpu_torch.data.loader import DataLoader
    from myrtle_vision_tpu_torch.detection import train as det_cli

    data = dict(det_data_config, train_subset=MG_DET_SUBSET,
                valid_subset=MG_DET_VALID)
    data["transform_ops_train"] = {
        "RandomResize": {"scales": [MG_DET_PX],
                         "max_size_ratio": [1333, 800]},
        "Normalize": det_data_config["transform_ops_train"]["Normalize"]}
    data_cfg = write_json("mg_det_data_config.json", data)
    config = yolos_small_config()
    tc = config["train_config"]
    tc.update(output_directory=os.path.join(WORK, "mg_det"),
              checkpoint_path="", epochs=1, warmup_epochs=0,
              pretrained_backbone=None, local_batch_size=2,
              global_batch_size=4)
    config["data_config_path"] = data_cfg
    config["dist_config"] = {"dist_backend": "gloo"}
    ref_config = json.loads(json.dumps(config))
    ref_config["train_config"].update(
        local_batch_size=4, output_directory=os.path.join(WORK, "mg_det1"))
    # each rank's valid boxes in the first step, as its loader takes them
    with contextlib.redirect_stdout(io.StringIO()):
        _, loader, _, _, _ = det_cli.build_train(config,
                                                 torch.device("cpu"))
    boxes = []
    for rank in range(2):
        shard = DataLoader(loader.dataset, batch_size=4, device="cpu",
                           shuffle=True, seed=tc["seed"],
                           collate_fn=loader.collate_fn,
                           process_shard=(rank, 2))
        batch = next(iter(shard.epoch(0)))
        boxes.append(int(batch["valid"].sum()))
    ref_cfg = write_json("mg_det_one.json", ref_config)
    text, ref_counts = counted_cli("myrtle_vision_tpu_torch.detection.train",
                                   ["-c", ref_cfg, "--device", "cuda"])
    ref = mg_losses(text, detection=True)
    cfg = write_json("mg_det.json", config)
    torch.cuda.empty_cache()
    runs, took = mg_launch("det", "myrtle_vision_tpu_torch.detection.train",
                           cfg)
    got = mg_losses(runs[0][0], detection=True)
    check(len(got) == len(ref) == 2, f"multigpu det: {got} / {ref}")
    d_box = max(abs(got[0][i] - ref[0][i]) for i in (2, 3))
    spread = max(abs(a - b) for g, r in zip(got, ref) for a, b in zip(g, r))
    print(f"multigpu: det: YOLOS-S at {MG_DET_PX} px, data 2 x model 1, 2 "
          f"steps of 2 images a rank; first-step valid boxes by rank "
          f"{boxes} (averaged: {sum(boxes) / 2}); (loss, ce, bbox, giou) "
          f"{got} against one process at 4 images {ref}: first-step box "
          f"losses |d| {d_box:.3g} (bar {LOSS_BAR:g} of the larger), the "
          f"ce of a rank's own weighted mean against the whole batch's and "
          f"the later step apart by at most {spread:.3g}; {took:.1f} s")
    print(f"timing: multigpu det step {mg_step_ms(runs[0][1]['times']):.3f} "
          f"ms a rank, one process {mg_step_ms(ref_counts['times']):.3f} ms; "
          f"{MG_SHARED} [{power}]")
    check(boxes[0] != boxes[1], f"multigpu det: equal box counts {boxes}")
    for i in (2, 3):
        check(abs(got[0][i] - ref[0][i])
              <= LOSS_BAR * max(1.0, abs(ref[0][i])),
              f"multigpu det: first-step {('bbox', 'giou')[i - 2]} loss")


# Tensor parallelism where the fused gate refuses (ROADMAP A9b): data 1 x
# model 2, each Block in the form the JAX GSPMD step gives it
# (parallel/tp.py): FP16_32's fused Blocks whole on both ranks; a
# discrete Block (MVT_NO_FUSE=1; YOLOS-S at 608 px, 1545 tokens, past
# fuses_at) split, its attention on 3 of the 6 heads; PyTorchINT8's
# two-pass step, pass 1 split with the observers of the split activations
# reduced over the group, pass 2 whole.  Two steps of 2 x 32 images (a
# detector: one of 2 images) on both ranks against one process.
MG_TP_DET_PX = 608
# layer 0's observers and those before it after the first step, against
# one process: the split products' sum order can move a snapped element a
# grid step.  Deeper, such flips compound over the blocks (27% of a
# converted model's logits identical kernel vs plain, PERF.md), so the
# later observers are printed; the two ranks' must be the same bits.
MG_OBS_BAR = 2.0 ** -8


@contextlib.contextmanager
def env_set(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def mg_observer_errors(tag):
    """The INT8 observers after the first step: whether rank 0's and rank
    1's are the same bits, and (largest |d| / max(|one process's|,
    2^-10), its name) of rank 0 against one process over layer 0's and
    those before it, and over the rest."""
    def load(name):
        return torch.load(os.path.join(WORK, f"mg_{tag}_{name}_grads.pt"
                                       ".observers.pt"), weights_only=True)

    got, other, ref = load("rank0"), load("rank1"), load("one")
    check(set(got) == set(other) == set(ref) and len(ref) > 0,
          f"multigpu {tag}: observer names")
    same = all(torch.equal(got[n], other[n]) for n in got)
    early, late = [], []
    for n, r in ref.items():
        d = (float((got[n] - r).abs() / r.abs().clamp_min(2.0 ** -10)), n)
        deep = n.startswith(("decoder.", "transformer.")) and \
            not n.startswith("transformer.layers.0.")
        (late if deep else early).append(d)
    return same, max(early), max(late)


def mg_gspmd_form(whole_ops=(), local_heads=None, observers=False):
    """A check of a TP-2 case's counts (``mg_classification``'s
    ``also``): no head-sharded launch (no res_scale); ``whole_ops``, the
    fused ops that run whole, launched on rank 0 as often as in one
    process; ``local_heads``, every discrete attention call in training
    on that many heads (rank 1, which does not validate, and rank 0 past
    its validation's whole Blocks), as many calls as one process makes
    on twice as many; ``observers``, rank 0's INT8 observers after the
    first step within MG_OBS_BAR of one process's."""
    def also(tag, counts0, counts1, ref):
        res = {k: v for k, v in counts0["res_scale"].items() if v}
        ops0 = {k: tuple(counts0["ops"][k]) for k in whole_ops}
        ops_ref = {k: tuple(ref["ops"][k]) for k in whole_ops}

        def flash(counts):
            return {k: v for k, v in counts["launches"].items()
                    if v and "flash" in k}

        print(f"multigpu: {tag}: rank 0 ops {ops0}, one process {ops_ref}; "
              f"discrete attention calls by heads: rank 0 "
              f"{counts0['heads']}, rank 1 {counts1['heads']}, one process "
              f"{ref['heads']}; flash launches rank 0 {flash(counts0)}, one "
              f"process {flash(ref)}")
        check(not res, f"multigpu {tag}: head-sharded launches {res}")
        check(ops0 == ops_ref and all(v[0] > 0 for v in ops0.values()),
              f"multigpu {tag}: whole ops {ops0} against {ops_ref}")
        if local_heads is not None:
            local, whole = str(local_heads), str(2 * local_heads)
            n = counts1["heads"].get(local, 0)
            validated = counts0["heads"].get(whole, 0)
            check(n > 0 and set(counts1["heads"]) == {local}
                  and counts0["heads"].get(local) == n
                  and set(counts0["heads"]) <= {local, whole}
                  and set(ref["heads"]) == {whole}
                  and validated + n == ref["heads"][whole],
                  f"multigpu {tag}: attention calls by heads "
                  f"{counts0['heads']} / {counts1['heads']} against "
                  f"{ref['heads']}")
            for k in ("flash_attention_fwd", "flash_attention_bwd"):
                check(counts0["launches"][k] == ref["launches"][k],
                      f"multigpu {tag}: {k} launches")
        if observers:
            same, (worst, name), (deep, deep_name) = mg_observer_errors(tag)
            print(f"multigpu: {tag}: INT8 observers after the first step: "
                  f"the two ranks' the same bits {same}; against one "
                  f"process, layer 0's and those before it largest "
                  f"relative |d| {worst:.4g} in {name} (bar "
                  f"{MG_OBS_BAR:g}), the deeper ones {deep:.4g} in "
                  f"{deep_name}")
            check(same, f"multigpu {tag}: the ranks' observers differ")
            check(worst <= MG_OBS_BAR, f"multigpu {tag}: observers")

    return also


def mg_detection_tp(det_data_config):
    """YOLOS-S in FP32 at MG_TP_DET_PX (past fuses_at: every Block split,
    the flash kernels on 3 of 6 heads) on data 1 x model 2 against one
    process, one step of 2 images on both: the first step's four losses
    (LOSS_BAR) and gradients (GRAD_BAR); each rank runs the host matcher
    and num_boxes on the same micro-batch.  Returns rank 0's counts."""
    data = dict(det_data_config, train_subset=2, valid_subset=MG_DET_VALID)
    data["transform_ops_train"] = {
        "RandomResize": {"scales": [MG_TP_DET_PX],
                         "max_size_ratio": [1333, 800]},
        "Normalize": det_data_config["transform_ops_train"]["Normalize"]}
    config = yolos_small_config()
    config["train_config"].update(
        output_directory=os.path.join(WORK, "mg_dettp"), checkpoint_path="",
        epochs=1, warmup_epochs=0, pretrained_backbone=None,
        local_batch_size=2, global_batch_size=2)
    config["data_config_path"] = write_json("mg_dettp_data_config.json",
                                            data)
    config["dist_config"] = {"dist_backend": "gloo", "tensor_parallel": 2}
    ref_config = json.loads(json.dumps(config))
    ref_config["train_config"]["output_directory"] = os.path.join(
        WORK, "mg_dettp1")
    ref_config["dist_config"] = {"dist_backend": "gloo"}
    ref_grads = os.path.join(WORK, "mg_det-tp_one_grads.pt")
    text, ref_counts = counted_cli(
        "myrtle_vision_tpu_torch.detection.train",
        ["-c", write_json("mg_dettp_one.json", ref_config), "--device",
         "cuda"], grads_path=ref_grads)
    ref = mg_losses(text, detection=True)
    torch.cuda.empty_cache()
    runs, took = mg_launch("det-tp", "myrtle_vision_tpu_torch.detection.train",
                           write_json("mg_dettp.json", config))
    got = mg_losses(runs[0][0], detection=True)
    check(len(got) == len(ref) == 1, f"multigpu det-tp: {got} / {ref}")
    worst, name = mg_grad_error(
        os.path.join(WORK, "mg_det-tp_rank0_grads.pt"), ref_grads)
    d = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(got[0], ref[0]))
    counts0 = runs[0][1]
    print(f"multigpu: det-tp: YOLOS-S at {MG_TP_DET_PX} px (1545 tokens, "
          f"past fuses_at), FP32, data 1 x model 2, one step of 2 images: "
          f"(loss, ce, bbox, giou) {got} against one process {ref}: "
          f"largest |d| {d:.3g} (bar {LOSS_BAR:g}), largest relative "
          f"first-step gradient error {worst:.4g} in {name} (bar "
          f"{GRAD_BAR:g}); attention calls by heads rank 0 "
          f"{counts0['heads']}, one process {ref_counts['heads']}; {took:.1f}"
          f" s for both ranks")
    check(d <= LOSS_BAR, "multigpu det-tp: first-step losses")
    check(worst <= GRAD_BAR, "multigpu det-tp: first-step gradients")
    mg_gspmd_form(local_heads=3)("det-tp", counts0, runs[1][1], ref_counts)
    return counts0


def mg_gspmd(config, det_data_config, power):
    """The TP-2 cases where the fused gate refuses (the comment above
    MG_TP_DET_PX).  Returns rank 0's counts by case."""
    def variant(name, tp, **vit):
        c = json.loads(json.dumps(config))
        c["train_config"]["output_directory"] = os.path.join(WORK,
                                                             f"mg_{name}")
        c["vit_config"].update(vit)
        if tp:
            c["dist_config"]["tensor_parallel"] = 2
        return c

    fused = ("fused_attention_block", "fused_mlp_block")
    counts = {}
    for tag, vit, env, also in (
            ("tp-FP16_32", {"q_format": "FP16_32"}, {},
             mg_gspmd_form(whole_ops=fused)),
            ("tp-nofuse", {}, {"MVT_NO_FUSE": "1"},
             mg_gspmd_form(local_heads=3)),
            ("tp-int8", {"q_format": "PyTorchINT8"}, {},
             mg_gspmd_form(whole_ops=("fused_attention_block_i8",
                                      "fused_mlp_block_i8"),
                           local_heads=3, observers=True))):
        with env_set(**env):
            counts[tag] = mg_classification(
                tag, variant(tag, True, **vit), variant(f"{tag}1", False,
                                                        **vit),
                power, also=also)
    counts["det-tp"] = mg_detection_tp(det_data_config)
    return counts


def phase_multigpu(device, power, data_config, det_data_config):
    """Multi-GPU training on the one card (see the comment above
    MG_C).  Returns the res_scale kernels' entries of the kernels
    line."""
    t0 = time.perf_counter()
    errors, totals = phase_multigpu_kernels(device, power)
    config = vit_small_config()
    tc = config["train_config"]
    tc.update(checkpoint_path="", epochs=1, warmup_epochs=0,
              pretrained_backbone=None, iters_per_checkpoint=1000,
              iters_per_val=1000, local_batch_size=32, global_batch_size=64)
    config["data_config_path"] = subset_data_config(
        data_config, MG_TRAIN_IMAGES, "mg")
    config["dist_config"] = {"dist_backend": "gloo"}
    nccl_config = json.loads(json.dumps(config))
    nccl_config["data_config_path"] = subset_data_config(
        data_config, 64 * MG_NCCL_STEPS, "mg_nccl")
    mg_nccl(device, power, nccl_config)

    def variant(name, **changes):
        c = json.loads(json.dumps(config))
        c["train_config"]["output_directory"] = os.path.join(WORK,
                                                             f"mg_{name}")
        for key, value in changes.items():
            section, field = key.split("__")
            c[section][field] = value
        return c

    depth = config["vit_config"]["depth"]
    steps = MG_TRAIN_IMAGES // 64
    # data 2 x model 1 at 32 images a rank, one micro-batch; one process
    # at 64, one micro-batch
    mg_classification("dp", variant("dp"),
                      variant("dp1", train_config__local_batch_size=64),
                      power)
    # data 1 x model 2 (2 x 32 a step on both); one process the same
    per_step = 2 * depth * 2  # two halves, two micro-batches
    res = {"gemm_bf16_epilogue": steps * per_step, "gemm_f32x3_epilogue": 0,
           "layernorm_rows_bwd": steps * per_step,
           "layernorm_snap_rows_bwd": 0}
    tp = mg_classification(
        "tp", variant("tp", dist_config__tensor_parallel=2), variant("tp1"),
        power, expect_res=res)
    res32 = {"gemm_bf16_epilogue": 0, "gemm_f32x3_epilogue": steps * per_step,
             "layernorm_rows_bwd": 0,
             "layernorm_snap_rows_bwd": steps * per_step}
    tp32 = mg_classification(
        "tp-fp32", variant("tp32", dist_config__tensor_parallel=2,
                           vit_config__compute_dtype="float32"),
        variant("tp32one", vit_config__compute_dtype="float32"), power,
        expect_res=res32)
    mg_detection(power, det_data_config)
    mg_gspmd(config, det_data_config, power)
    print(f"multigpu: phase took {time.perf_counter() - t0:.1f} s")
    entries = []
    for name, (counter, source, replaces) in RES_SCALE_KERNELS.items():
        t = totals[counter]
        launched = (tp32 if "f32" in name or "snap" in name
                    else tp)["res_scale"][counter]
        check(launched > 0, f"{name} never launched on its path")
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # rank 0's launches in the two-rank tensor-parallel train CLI
            # (bf16 or fp32 compute); the largest error against the plain
            # version; per ViT-S/16 block at the local widths of n_tp = 2,
            # B=64 (one model rank's share)
            "launches": launched, "max_abs_err": errors[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": max(t["by"], key=t["by"].get),
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
        })
    return entries


def main():
    require_cuda()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # the train CLIs' scalars logged before this run
    scalar_offset = len(scalar_lines(0) or [])
    seconds = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its seconds recorded under ``name``."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    timed("device", phase_device)
    timed("build", phase_build)
    errors = timed("kernels", phase_kernels, device)
    f32_errors = timed("kernels-f32", phase_kernels_f32, device)
    probe_entries = timed("probes", phase_probes, device, power_line())
    data_config, data_cfg = timed("dataset", make_dataset)
    timed("main", phase_main, device, data_config, data_cfg)
    launches = timed("train", phase_train, device, data_config, data_cfg)
    int8_launches, int8_ckpt, int8_kwargs = timed(
        "quantize", phase_quantize, device, data_config, data_cfg)
    float_launches, float_ckpt, float_kwargs = timed(
        "quantize-float", phase_quantize_float, device, data_config,
        data_cfg)
    qat_launches = timed("qat", phase_qat, device, data_config, data_cfg)
    i8_errors = timed("kernels-qat-int8", phase_kernels_qat_int8, device)
    i8_ops = timed("qat-int8", phase_qat_int8, device, data_config, data_cfg)
    long_i8_errors = timed("int8-long", phase_kernels_long_int8, device)
    i8_384_train, i8_384_ptq, i8_384_ckpt, i8_384_kwargs = timed(
        "int8-384", phase_int8_384, device)
    gate_launches, gate_errors, gate_totals = timed(
        "ptq-gate", phase_ptq_gate, device, power_line(), int8_ckpt)
    t0 = time.perf_counter()
    det_data = timed("detect-dataset", make_detection_dataset)
    print(f"detect: synthetic DIOR-layout set (600 train, 96 val, 96 test "
          f"images of 160 px) in {time.perf_counter() - t0:.1f} s")
    det_launches = timed("detect", phase_detect, device, *det_data)
    det_train_launches = timed("detect-train", phase_detect_train, device,
                               *det_data)
    float_det_launches = timed("detect-float", phase_detect_float, device,
                               *det_data)
    timed("detect-int8", phase_detect_int8, device, *det_data)
    tiny_launches = timed("detect-tiny", phase_detect_tiny, device,
                          *det_data)
    f32_runs, f32_ckpt, f32_config_ = timed(
        "fp32", phase_fp32, device, data_config, det_data)
    power = power_line()
    timed("seg", phase_seg, device, power)
    timed("distill", phase_distill, device, power, data_config, data_cfg)
    timed("remainder", phase_remainder, device, data_config, data_cfg,
          f32_ckpt, f32_config_, scalar_offset)
    totals = timed("timing", phase_timing, device, power, int8_ckpt,
                   int8_kwargs, float_ckpt, float_kwargs, i8_384_ckpt,
                   i8_384_kwargs)
    f32_totals = timed("timing-f32", time_f32, device, power)
    mg_entries = timed("multigpu", phase_multigpu, device, power,
                       data_config, det_data[0])
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # launches on the path's own run: the train CLI for the FP32
            # kernels, the PTQ CLI for the INT8 ones and for the float
            # formats' (FP16_32), the QAT train CLI (FP16_32) for the
            # float formats' backward, the detection eval CLI for the
            # flash forward, the detection train CLI for the flash
            # backward, the FP16_32 detection train CLI for the float
            # formats' long core
            "launches": (int8_launches if name in INT8_KERNELS
                         else float_launches if name in FLOAT_KERNELS
                         else qat_launches if name in QAT_KERNELS
                         else det_launches if name == "flash_attention_fwd"
                         else det_train_launches
                         if name == "flash_attention_bwd"
                         else float_det_launches
                         if name in LONG_FLOAT_KERNELS
                         else launches)[name],
            "max_abs_err": errors[name],
            # sums over this kernel's launches in one ViT-S/16 block at
            # B=256: a train step (FP32 kernels), a converted forward
            # (INT8, FP16_32), a QAT step's backward (FP16_32: the two
            # float backward kernels); the flash forward's one launch in a YOLOS-S
            # block at 800 px, B=8; the flash backward's one call (three
            # kernels) in a YOLOS-S block at 608 px, B=8; the float long
            # core's one call, forward or backward (two or four kernels), in a
            # YOLOS-S FP16_32 block at 384 px, B=8
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": max(t["by"], key=t["by"].get),
            "library_ms": t["library_ms"],
            # the profiler's device time of the same launches
            "device_ms": t["device_ms"],
        })
        if name in DETECT_KERNELS + LONG_KERNELS + LONG_FLOAT_KERNELS:
            # the flash kernels at both regimes' shapes, each case's own
            # numbers: the K6 / K7 shapes summed above and the K5 / K8
            # ones; the fused core's cases: the ViT-S/16 block's, the long
            # route forced at 197 tokens and at YOLOS-S's 677 (B=8 and 2);
            # the float long core's at 677 (B=8 and 2)
            kernels[-1]["cases"] = t["cases"]
    for (name, replaces), runs in zip(LONG_INT8_KERNELS.items(),
                                      (i8_384_train, i8_384_ptq)):
        t = totals[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": KERNELS["attention_core_f32_long"][0],
            "replaces": replaces,
            # the long core's launches on the 384 px INT8 paths: the
            # two-pass train CLI (site mode), the PTQ CLI (int8 mode); its
            # largest error against the plain version over
            # LONG_INT8_CASES; per call at ViT-S/16 384 px, B=8 (one a
            # block), the yardstick fp32 SDPA then the site's quantize
            "launches": runs["attention_core_f32_long"],
            "max_abs_err": long_i8_errors[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": max(t["by"], key=t["by"].get),
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
        })
    for name, base, case in SWEEP_KERNELS:
        t = totals[base]["cases"][case]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNELS[base][0],
            "replaces": f"{KERNELS[base][1]} (above 768 tokens)",
            # the launches of phase detect-tiny's YOLOS-Ti FP16_32 train
            # CLI runs (480 and 464 px); the largest error against the
            # plain version over SWEEP_CASES; per call at YOLOS-Ti's 480
            # px micro-batch, every timed shape in "cases"
            "launches": tiny_launches[base],
            "max_abs_err": errors[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "cases": {k: v for k, v in totals[base]["cases"].items()
                      if k.startswith(name[:-1])},
        })
    for name in ("layernorm_quant_rows", "gemm_s8_epilogue"):
        t = gate_totals[name]
        kernels.append({
            "name": f"{name}[discrete]", "route": "cuda",
            "source": KERNELS[name][0],
            "replaces": f"{KERNELS[name][1]} (past the fused gate: the "
                        "discrete converted Block)",
            # the 448 px PTQ CLI's launches (phase ptq-gate); the largest
            # error against the plain version at block 0 of its first test
            # batch; per discrete converted block at B=32, N=785
            "launches": gate_launches[name], "max_abs_err": gate_errors[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": max(t["by"], key=t["by"].get),
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
        })
    for name, (source, replaces, tpu) in INT8_QAT_VARIANTS.items():
        t = totals[tpu]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # the INT8 QAT train CLI's launches of the op, forward or
            # backward; its largest error against the plain chain at B=64;
            # per ViT-S/16 block at B=256 the chain's ms, the sums of its
            # kernels' bounds and yardsticks
            "launches": i8_ops[name.split("[")[0]][int("[bwd]" in name)],
            "max_abs_err": i8_errors[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
        })
    for name, (source, replaces) in F32_KERNELS.items():
        t = f32_totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # launches on the fp32 paths' runs (the MVT_NO_FUSE=1 train
            # CLI, YOLOS-S's 800 px forward and its 608 / 384 px steps);
            # the largest error against the plain version over the fp32
            # flash cases; per call at YOLOS-S's 800 px (K6, B=8) or 608 px
            # (K7, B=8) shape, the K5 / K8 ViT-S/16 cases in "cases"
            "launches": f32_runs[name],
            "max_abs_err": f32_errors[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": max(t["by"], key=t["by"].get),
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "cases": t["cases"],
        })
    for name, (source, replaces, tpu) in F32_ROUTE.items():
        t = f32_totals[tpu]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # the fp32 ViT-S/16 train CLI's launches of the op, forward or
            # backward; the largest error against the plain chain's true
            # fp32; per ViT-S/16 block at B=256
            "launches": f32_runs[name],
            "max_abs_err": f32_errors[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
        })
    for entry in probe_entries:
        # the profiler's device time of the headline variant, B=512
        entry["device_ms"] = totals["probes"][entry["name"]]
    kernels += probe_entries + mg_entries
    print("phase seconds: " + json.dumps(seconds))
    print(f"elapsed: {time.perf_counter() - START:.1f} s since the script "
          "started")
    print(json.dumps({"kernels": kernels}))
    print(power_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--counted"]:
        # one rank of the multigpu phase: python chip_smoke.py --counted
        # <counts.json> <grads.pt> <train CLI module> <its arguments>
        print(counted_cli(sys.argv[4], sys.argv[5:], sys.argv[2],
                          sys.argv[3])[0])
    else:
        main()
