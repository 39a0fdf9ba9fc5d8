#!/usr/bin/env python3
"""The attention cores above 256 tokens and the float-format and INT8 QAT
LayerNorm prologue on one card, for one or more checkouts, alternating
them, so that a change is held against its parent under the same
conditions: the fused bf16 core's long route (``attention_core`` and
``attention_core_bwd``), the fp32 core's long route of the float formats,
INT8 QAT and converted INT8 (``attention_core_snap``,
``attention_core_f32`` and ``attention_core_f32_bwd``) and
``layernorm_snap_rows``.

    python3 tools/perf/core_long_bench.py <root> [<root> ...] [--rounds 1]
        [--groups bf16,f32,ln,sweep]

Each round runs the roots in order and then in reverse (parent, change,
change, parent for two), each in a fresh process that puts its root
first on ``sys.path`` and so builds and runs that checkout's kernels.  A
measurement times, with CUDA events, each case on inputs drawn from a
seed, beside PyTorch yardsticks on the same inputs and each call's bound
(``perf/_timing.py``), and the profiler's device time kernel by kernel.

- bf16: the forward with statistics and the backward at YOLOS-S's 384 px
  shape (6 heads of 64, N = 677) at batch 8 and at the train step's
  micro-batch of 2, on bf16 qkv rows and an fp32 output-projection
  gradient; the yardsticks PyTorch's flash-attention forward and backward
  (SDPA).
- f32: the FP16_32 forward with statistics (as the QAT forward runs it)
  and the backward at (8, 677) and (2, 677); at ViT-S/16's 384 px shape
  (8, 577) the INT8 site mode with statistics (INT8 QAT's pass 2), the
  int8-output mode (the converted model) and the backward; fp32 qkv rows
  and output gradient at std 1, a calibrated site; the yardsticks fp32
  ``F.scaled_dot_product_attention`` forward and backward, followed by
  the site's snap or quantize for the int8 modes (two calls).  The bf16
  kernels are a control where only the fp32 core changed.
- ln: ``layernorm_snap_rows`` on fp32 rows of 384 (ViT-S/16's width) at
  std 1: FP16_32 and INT8 QAT's site policy (a calibrated site) at
  ViT-S/16's 224 px step at B=256 (50,432 rows) and its 384 px step at
  B=256 (147,712 rows, 577 tokens), FP16_32 at YOLOS-S's 384 px
  micro-batch (2 x 677 = 1,354 rows); the yardstick ``F.layer_norm``.
  Beside it the kernels that run the same float snap
  (``csrc/fake_quant.cuh``), in FP16_32 at ViT-S/16, B=256: the
  LayerNorm backward (``layernorm_rows_bwd`` with a qspec, its column
  sums included), the 3-pass GEMM's fc1 epilogue (bias, snap, GELU,
  snap) and the fp32 attention core's snap mode with its statistics, and
  K11 (``fake_quant_rows``, e5m10) on the patch embedding's (256, 196,
  768) input.

- sweep: the fp32 core's forward past its score block (past 768 tokens,
  the cluster design), FP16_32 with
  statistics, at chip_smoke.py's ``SWEEP_TIMED`` shapes: YOLOS-Ti's 480
  px micro-batch (2, 3 heads of 64, N = 1001), batch 8, and the fused
  gate's longest (2, one head of 32, N = 1837); fp32 qkv rows at std 1;
  the yardstick fp32 ``F.scaled_dot_product_attention``.

``--groups`` picks the groups (all four by default).  Each root also
saves its outputs of the first round, and the tool prints for every
later root, case by case, the count of elements whose bits differ from
the first root's and the largest |difference|.  Prints one
line per measurement and, last, each time per root (median over the
rounds).  Needs a CUDA device.
"""
import json
import os
import statistics
import subprocess
import sys
import tempfile

GROUPS = ("bf16", "f32", "ln", "sweep")
SHAPES = ((8, 677), (2, 677))
F32_SHAPES = ((8, 677), (2, 677))
F32_INT8_SHAPE = (8, 577)
HEADS, D = 6, 64
# layernorm_snap_rows: (rows, policy) at width 384
LN_COLS = 384
LN_CASES = ((256 * 197, "FP16_32"), (256 * 197, "int8"),
            (256 * 577, "FP16_32"), (256 * 577, "int8"), (2 * 677, "FP16_32"))
LN_BWD_CASE = f"layernorm_snap_rows_bwd FP16_32 rows={LN_CASES[0][0]}"
# the sweep group's (B, heads, N, D)
SWEEP_SHAPES = ((2, 3, 1001, 64), (8, 3, 1001, 64), (2, 1, 1837, 32))
K11_SHAPE = (256, 196, 768)
K11_CASE = "fake_quant_rows e5m10 (256, 196, 768)"
FC1_CASE = f"gemm_f32x3_epilogue fc1 FP16_32 rows={LN_CASES[0][0]}"
CORE_CASE = "attention_core_f32 snap+stats FP16_32 B=256 N=197"


def bf16_cases(torch, K, dev):
    """{case: thunk} of the bf16 long core and its yardsticks."""
    c, scale = HEADS * D, D ** -0.5
    cases = {}
    for b, n in SHAPES:
        gen = torch.Generator(dev).manual_seed(n)
        qkv = torch.randn(b, n, 3 * c, device=dev, generator=gen).to(
            torch.bfloat16)
        d_o = torch.randn(b, n, c, device=dev, generator=gen)
        _, m, rs = K.attention_core_plain(qkv, HEADS, scale, stats=True)
        q, k, v = (t.contiguous() for t in qkv.view(
            b, n, 3, HEADS, D).permute(2, 0, 3, 1, 4))
        do = d_o.to(torch.bfloat16).view(b, n, HEADS, D).transpose(
            1, 2).contiguous()
        fwd = torch.ops.aten._scaled_dot_product_flash_attention(
            q, k, v, 0.0, False, False, scale=scale)
        o, lse, cq, ck, mq, mk, ps, po = fwd[:8]
        tag = f"B={b} N={n}"
        cases.update({
            f"forward {tag}": lambda qkv=qkv: K.attention_core_cuda(
                qkv, HEADS, scale, stats=True),
            f"backward {tag}": lambda qkv=qkv, d_o=d_o, m=m, rs=rs:
                K.attention_core_bwd_cuda(qkv, d_o, m, rs, HEADS, scale),
            f"SDPA forward {tag}": lambda q=q, k=k, v=v:
                torch.ops.aten._scaled_dot_product_flash_attention(
                    q, k, v, 0.0, False, False, scale=scale),
            f"SDPA backward {tag}": lambda a=(do, q, k, v, o, lse, cq, ck,
                                              mq, mk, ps, po):
                torch.ops.aten._scaled_dot_product_flash_attention_backward(
                    *a[:10], 0.0, False, *a[10:], scale=scale),
        })
    return cases, set()


def f32_cases(torch, K, dev):
    """({case: thunk}, the cases whose outputs are compared across roots)
    of the fp32 long core and its yardsticks."""
    import torch.nn.functional as F

    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites
    from myrtle_vision_tpu_torch.quantize import affine_uint8_qparams

    c, scale = HEADS * D, D ** -0.5
    fp16_32 = (5, 10, False)
    cases, kept = {}, set()

    def inputs(b, n):
        gen = torch.Generator(dev).manual_seed(1000 * b + n)
        qkv = torch.randn(b, n, 3 * c, device=dev, generator=gen)
        d_o = torch.randn(b, n, c, device=dev, generator=gen)
        q, k, v = (t.contiguous() for t in qkv.view(
            b, n, 3, HEADS, D).permute(2, 0, 3, 1, 4))
        return qkv, d_o, q, k, v

    def sdpa_bwd(q, k, v, d_oh):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        return lambda: torch.autograd.grad(out, leaves, d_oh,
                                           retain_graph=True)

    def backward(tag, qkv, d_o, m, rs, q, k, v):
        d_oh = d_o.view(qkv.shape[0], -1, HEADS, D).transpose(
            1, 2).contiguous()
        cases[f"f32 backward {tag}"] = \
            lambda: K.attention_core_f32_bwd_cuda(qkv, d_o, m, rs, HEADS,
                                                  scale)
        kept.add(f"f32 backward {tag}")
        cases[f"fp32 SDPA backward {tag}"] = sdpa_bwd(q, k, v, d_oh)

    for b, n in F32_SHAPES:
        tag = f"B={b} N={n}"
        qkv, d_o, q, k, v = inputs(b, n)
        _, m, rs = K.attention_context_f32(qkv, HEADS, scale, stats=True)
        cases[f"f32 forward FP16_32+stats {tag}"] = \
            lambda qkv=qkv: K.attention_core_snap_cuda(
                qkv, HEADS, scale, fp16_32, stats=True)
        kept.add(f"f32 forward FP16_32+stats {tag}")
        cases[f"fp32 SDPA forward {tag}"] = \
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, scale=scale)
        backward(tag, qkv, d_o, m, rs, q, k, v)

    b, n = F32_INT8_SHAPE
    tag = f"B={b} N={n}"
    qkv, d_o, q, k, v = inputs(b, n)
    ctx = K.attention_context_f32(qkv, HEADS, scale)
    s, zp = affine_uint8_qparams(ctx.min(), ctx.max())
    site = torch.stack([s, zp, torch.ones_like(s)])

    def sdpa_ctx():
        return F.scaled_dot_product_attention(q, k, v, scale=scale
                                              ).transpose(1, 2).reshape(
            b, n, c)

    cases.update({
        f"f32 forward int8 sites+stats {tag}":
            lambda: K.attention_core_snap_cuda(qkv, HEADS, scale,
                                               Int8Sites(site), stats=True),
        f"fp32 SDPA + site snap {tag}": lambda: K.requant(sdpa_ctx(), site),
        f"f32 forward int8 out {tag}":
            lambda: K.attention_core_f32_cuda(qkv, HEADS, scale, site),
        f"fp32 SDPA + quantize {tag}":
            lambda: K.quantize_i8(sdpa_ctx(), site),
    })
    kept.update({f"f32 forward int8 sites+stats {tag}",
                 f"f32 forward int8 out {tag}"})
    _, m, rs = K.attention_core_snap_plain(qkv, HEADS, scale,
                                           Int8Sites(site), stats=True)
    backward(tag, qkv, d_o, m, rs, q, k, v)
    return cases, kept


def ln_cases(torch, K, dev):
    """({case: thunk}, the cases whose outputs are compared across roots)
    of layernorm_snap_rows and its yardstick."""
    import torch.nn.functional as F

    from myrtle_vision_tpu_torch.ops.fake_quant import Int8Sites
    from myrtle_vision_tpu_torch.quantize import affine_uint8_qparams

    cases, kept, inputs = {}, set(), {}
    for rows, policy in LN_CASES:
        if rows not in inputs:
            gen = torch.Generator(dev).manual_seed(rows)
            x = torch.randn(rows, LN_COLS, device=dev, generator=gen)
            scale = 1 + 0.1 * torch.randn(LN_COLS, device=dev, generator=gen)
            bias = 0.1 * torch.randn(LN_COLS, device=dev, generator=gen)
            y = F.layer_norm(x, (LN_COLS,), scale, bias, K.EPS)
            s, zp = affine_uint8_qparams(y.min(), y.max())
            site = torch.stack([s, zp, torch.ones_like(s)])
            inputs[rows] = x, scale, bias, site
            cases[f"F.layer_norm rows={rows}"] = \
                lambda x=x, s=scale, b=bias: F.layer_norm(x, (LN_COLS,), s,
                                                          b, K.EPS)
        x, scale, bias, site = inputs[rows]
        q = Int8Sites(site) if policy == "int8" else (5, 10, False)
        name = f"layernorm_snap_rows {policy} rows={rows}"
        cases[name] = lambda x=x, s=scale, b=bias, q=q: \
            K.layernorm_snap_rows_cuda(x, s, b, q)
        kept.add(name)
    x, scale, _, _ = inputs[LN_CASES[0][0]]
    gen = torch.Generator(dev).manual_seed(1)
    dxn, do = (torch.randn(x.shape, device=dev, generator=gen)
               for _ in range(2))
    patches = torch.randn(*K11_SHAPE, device=dev, generator=gen)
    # fc1's weight as the model holds it: the (in, out) view of a torch
    # (out, in) tensor
    w1 = (torch.randn(4 * LN_COLS, LN_COLS, device=dev, generator=gen)
          * LN_COLS ** -0.5).t()
    b1 = torch.randn(4 * LN_COLS, device=dev, generator=gen)
    qkv = torch.randn(256, 197, 3 * LN_COLS, device=dev, generator=gen)
    fp16_32 = (5, 10, False)
    cases.update({
        LN_BWD_CASE: lambda: K.layernorm_rows_bwd_cuda(x, scale, dxn, do,
                                                       fp16_32),
        FC1_CASE: lambda: K.gemm_f32x3_epilogue_cuda(
            x, w1, b1, "bias_snap_gelu_snap", fp16_32),
        CORE_CASE: lambda: K.attention_core_snap_cuda(
            qkv, HEADS, D ** -0.5, fp16_32, stats=True),
        K11_CASE: lambda: K.fake_quant_rows_cuda(patches, "float", 5, 10)})
    kept.update({LN_BWD_CASE, FC1_CASE, CORE_CASE, K11_CASE})
    return cases, kept


def sweep_cases(torch, K, dev):
    """({case: thunk}, the cases whose outputs are compared across roots)
    of the fp32 core's forward past 768 tokens and its yardstick."""
    import torch.nn.functional as F

    cases, kept = {}, set()
    for b, h, n, d in SWEEP_SHAPES:
        gen = torch.Generator(dev).manual_seed(1000 * b + n)
        qkv = torch.randn(b, n, 3 * h * d, device=dev, generator=gen)
        q, k, v = (t.contiguous() for t in qkv.view(
            b, n, 3, h, d).permute(2, 0, 3, 1, 4))
        tag = f"B={b} H={h} N={n} D={d}"
        name = f"f32 forward past 768 FP16_32+stats {tag}"
        cases[name] = lambda qkv=qkv, h=h, d=d: K.attention_core_snap_cuda(
            qkv, h, d ** -0.5, (5, 10, False), stats=True)
        kept.add(name)
        cases[f"fp32 SDPA forward {tag}"] = \
            lambda q=q, k=k, v=v, d=d: F.scaled_dot_product_attention(
                q, k, v, scale=d ** -0.5)
    return cases, kept


CASE_GROUPS = {"bf16": bf16_cases, "f32": f32_cases, "ln": ln_cases,
               "sweep": sweep_cases}


def measure(root, save, groups):
    """{case: (ms, device ms, {kernel: device ms})} of the checkout at
    ``root`` for the case groups ``groups``; the outputs of the compared
    cases into ``save`` (a path, or "" for none)."""
    sys.path.insert(0, root)
    import torch

    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.perf._timing import (
        cuda_ms,
        kernel_device_ms,
    )

    if not torch.cuda.is_available():
        raise SystemExit("core_long_bench: no CUDA device")
    dev = torch.device("cuda", 0)
    cases, kept = {}, set()
    for group in groups:
        got, keep = CASE_GROUPS[group](torch, K, dev)
        cases.update(got)
        kept |= keep
    out, outputs = {}, {}
    for name, fn in cases.items():
        if save and name in kept:
            res = fn()
            outputs[name] = [t.detach().cpu() for t in (
                res if isinstance(res, tuple) else (res,))]
        ms = cuda_ms(fn, iters=50, warmup=5)
        dev_ms, by_kernel, _ = kernel_device_ms(fn)
        out[name] = (ms, dev_ms, by_kernel)
    if save:
        torch.save(outputs, save)
    return out


def compare(first, other):
    """Lines of the bitwise comparison of two roots' saved outputs."""
    import torch

    a, b = torch.load(first), torch.load(other)
    lines = []
    for case in sorted(a):
        for i, (x, y) in enumerate(zip(a[case], b[case])):
            if x.dtype == torch.float32:
                differ = int((x.view(torch.int32) != y.view(torch.int32))
                             .sum())
                gap = float((x - y).abs().nan_to_num(float("inf")).max())
            else:
                differ = int((x != y).sum())
                gap = float((x.float() - y.float()).abs().max())
            lines.append(f"{case} output {i}: {differ} of {x.numel()} "
                         f"elements differ, max |diff| {gap:g}")
    return lines


def bounds(groups):
    """Print each timed kernel case's bound."""
    from myrtle_vision_tpu_torch.perf._timing import bound, cost

    c = HEADS * D
    rows = []
    if "ln" in groups:
        # reads x and both (cols,) parameters once, writes the output; 14
        # fp32 operations an element outside the snaps
        rows += [(f"layernorm_snap_rows {policy} rows={r}",
                  cost(4 * (2 * r * LN_COLS + 2 * LN_COLS),
                       14 * r * LN_COLS, "fp32"))
                 for r, policy in LN_CASES]
        # the backward reads x, dxn and do and writes dx, reads scale and
        # writes both parameter gradients; K11 reads and writes each value
        # fc1: three bf16 products of (rows, 384) x (384, 1536), fp32 in
        # and out; the core: two N x N x 64 products a head, 3-pass
        r, n = LN_CASES[0][0], 256 * 196 * 768
        hid, core = 4 * LN_COLS, 4 * 256 * HEADS * 197 * 197 * D
        rows += [(LN_BWD_CASE, cost(4 * (4 * r * LN_COLS + 3 * LN_COLS),
                                    16 * r * LN_COLS, "fp32")),
                 (FC1_CASE, cost(4 * (r * LN_COLS + LN_COLS * hid + hid
                                      + r * hid),
                                 3 * 2 * r * LN_COLS * hid, "bf16")),
                 (CORE_CASE, cost(4 * (r * 3 * LN_COLS + r * LN_COLS
                                       + 2 * 256 * HEADS * 197),
                                  3 * core, "bf16")),
                 (K11_CASE, cost(4 * 2 * n, 10 * n, "fp32"))]
    for b, n in SHAPES if "bf16" in groups else ():
        flops, qkv, bhn = (2 * b * HEADS * n * n * D, 2 * b * n * 3 * c,
                           4 * b * HEADS * n)
        # forward: reads qkv, writes the context and both statistics (two
        # products); backward: reads qkv, d_o and both statistics, writes
        # dqkv and its column sums (five products)
        rows += [(f"forward B={b} N={n}",
                  cost(qkv * 4 // 3 + 2 * bhn, 2 * flops, "bf16")),
                 (f"backward B={b} N={n}",
                  cost(2 * qkv + 4 * b * n * c + 2 * bhn + 4 * b * 3 * c,
                       5 * flops, "bf16"))]
    for b, n in F32_SHAPES + (F32_INT8_SHAPE,) if "f32" in groups else ():
        tag = f"B={b} N={n}"
        # the 3-pass products' bf16 operations; the fp32 qkv read and the
        # output written once each
        flops, qkv, bhn = (2 * b * HEADS * n * n * D, 4 * b * n * 3 * c,
                           4 * b * HEADS * n)
        ctx = 4 * b * n * c
        rows.append((f"f32 backward {tag}",
                     cost(2 * qkv + ctx + 2 * bhn + 4 * b * 3 * c,
                          3 * 5 * flops, "bf16")))
        if (b, n) == F32_INT8_SHAPE:
            rows += [(f"f32 forward int8 sites+stats {tag}",
                      cost(qkv + ctx + 2 * bhn, 3 * 2 * flops, "bf16")),
                     (f"f32 forward int8 out {tag}",
                      cost(qkv + ctx // 4, 3 * 2 * flops, "bf16"))]
        else:
            rows.append((f"f32 forward FP16_32+stats {tag}",
                         cost(qkv + ctx + 2 * bhn, 3 * 2 * flops, "bf16")))
    for b, h, n, d in SWEEP_SHAPES if "sweep" in groups else ():
        # S and P V once at three bf16 passes; the fp32 qkv read and the
        # context and both statistics written once; beside it S once on
        # the FMA units (3 d fp32 FMAs a score, the keys padded to 64)
        tag = f"B={b} H={h} N={n} D={d}"
        flops = 2 * b * h * n * n * d
        moved = 4 * b * n * 4 * h * d + 8 * b * h * n
        fma = 3 * d * (-(-n // 64) * 64) * n * b * h
        rows += [(f"f32 forward past 768 FP16_32+stats {tag}",
                  cost(moved, 3 * 2 * flops, "bf16")),
                 (f"f32 forward past 768 FP16_32+stats {tag}, S once on "
                  "the FMA units", cost(0, 2 * fma, "fp32"))]
    for name, c_ in rows:
        ms, by = bound(c_)
        print(f"core_long_bench: {name} bound {ms:.4f} ms ({by}: "
              f"{c_['bytes']} bytes, {c_['ops']} {c_['peak']} ops)")


def main():
    args = sys.argv[1:]
    if args and args[0] == "--measure":
        print(json.dumps(measure(args[1], args[2], args[3].split(","))))
        return
    rounds, groups = 1, ",".join(GROUPS)
    for flag in ("--rounds", "--groups"):
        if flag in args:
            i = args.index(flag)
            if flag == "--rounds":
                rounds = int(args[i + 1])
            else:
                groups = args[i + 1]
            del args[i:i + 2]
    if not set(groups.split(",")) <= set(GROUPS):
        raise SystemExit(f"core_long_bench: --groups takes {GROUPS}")
    roots = [os.path.abspath(r) for r in args]
    if not roots:
        raise SystemExit(__doc__)
    sys.path.insert(0, roots[-1])
    from myrtle_vision_tpu_torch.perf._timing import power_line

    power = power_line()
    bounds(groups.split(","))
    times = {r: {} for r in roots}
    with tempfile.TemporaryDirectory() as tmp:
        saved = {}
        for rnd in range(rounds):
            for root in roots + roots[::-1]:
                save = ""
                if root not in saved:
                    save = saved[root] = os.path.join(
                        tmp, f"{len(saved)}.pt")
                res = json.loads(subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--measure",
                     root, save, groups], check=True, capture_output=True,
                    text=True).stdout.splitlines()[-1])
                for case, (ms, dev_ms, by_kernel) in res.items():
                    times[root].setdefault(case, []).append(ms)
                    kern = "; ".join(f"{k} {v:.4f}"
                                     for k, v in sorted(by_kernel.items()))
                    dev = ("not measured" if dev_ms is None
                           else f"{dev_ms:.4f} ms ({kern})")
                    print(f"core_long_bench: round {rnd} {root} {case}: "
                          f"{ms:.4f} ms, device {dev} [{power}]")
        for root in roots[1:]:
            for line in compare(saved[roots[0]], saved[root]):
                print(f"core_long_bench: {root} against {roots[0]}: {line}")
    for root in roots:
        for case, ts in times[root].items():
            print(f"core_long_bench: {root} {case}: median "
                  f"{statistics.median(ts):.4f} ms of "
                  f"{' '.join(f'{t:.4f}' for t in ts)} [{power}]")


if __name__ == "__main__":
    main()
