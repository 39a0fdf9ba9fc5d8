#!/usr/bin/env python3
"""The fused attention core above 256 tokens (the long route of
``attention_core`` and ``attention_core_bwd``) on one card, for one or
more checkouts, alternating them, so that a change is held against its
parent under the same conditions.

    python3 tools/perf/core_long_bench.py <root> [<root> ...] [--rounds 1]

Each round runs the roots in order and then in reverse (parent, change,
change, parent for two), each in a fresh process that puts its root
first on ``sys.path`` and so builds and runs that checkout's kernels.  A
measurement times, with CUDA events, the forward with statistics and the
backward at YOLOS-S's 384 px shape (6 heads of 64, N = 677) at batch 8
and at the train step's micro-batch of 2, on bf16 qkv rows and an fp32
output-projection gradient drawn from seed 677, beside PyTorch's
flash-attention forward and backward (SDPA) on the same q, k, v (the
yardsticks) and each call's bound (``perf/_timing.py``); and the
profiler's device time kernel by kernel.  Prints one line per
measurement and, last, each time per root (median over the rounds).
Needs a CUDA device.
"""
import json
import os
import statistics
import subprocess
import sys

SHAPES = ((8, 677), (2, 677))
HEADS, D = 6, 64


def measure(root):
    """{case: (ms, device ms, {kernel: device ms})} of the checkout at
    ``root``."""
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
    c, scale = HEADS * D, D ** -0.5
    out = {}
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
        cases = {
            "forward": lambda: K.attention_core_cuda(qkv, HEADS, scale,
                                                     stats=True),
            "backward": lambda: K.attention_core_bwd_cuda(qkv, d_o, m, rs,
                                                          HEADS, scale),
            "SDPA forward": lambda:
                torch.ops.aten._scaled_dot_product_flash_attention(
                    q, k, v, 0.0, False, False, scale=scale),
            "SDPA backward": lambda:
                torch.ops.aten._scaled_dot_product_flash_attention_backward(
                    do, q, k, v, o, lse, cq, ck, mq, mk, 0.0, False, ps, po,
                    scale=scale),
        }
        for name, fn in cases.items():
            ms = cuda_ms(fn, iters=50, warmup=5)
            dev_ms, by_kernel, _ = kernel_device_ms(fn)
            out[f"{name} B={b} N={n}"] = (ms, dev_ms, by_kernel)
    return out


def main():
    args = sys.argv[1:]
    if args and args[0] == "--measure":
        print(json.dumps(measure(args[1])))
        return
    rounds = 1
    if "--rounds" in args:
        i = args.index("--rounds")
        rounds = int(args[i + 1])
        del args[i:i + 2]
    roots = [os.path.abspath(r) for r in args]
    if not roots:
        raise SystemExit(__doc__)
    sys.path.insert(0, roots[-1])
    from myrtle_vision_tpu_torch.perf._timing import bound, cost, power_line

    power = power_line()
    for b, n in SHAPES:
        c, flops = HEADS * D, 2 * b * HEADS * n * n * D
        qkv, bhn = 2 * b * n * 3 * c, 4 * b * HEADS * n
        # forward: reads qkv, writes the context and both statistics (two
        # products); backward: reads qkv, d_o and both statistics, writes
        # dqkv and its column sums (five products)
        for name, c_ in (("forward", cost(qkv * 4 // 3 + 2 * bhn,
                                          2 * flops, "bf16")),
                         ("backward", cost(2 * qkv + 4 * b * n * c
                                           + 2 * bhn + 4 * b * 3 * c,
                                           5 * flops, "bf16"))):
            ms, by = bound(c_)
            print(f"core_long_bench: {name} B={b} N={n} bound {ms:.4f} ms "
                  f"({by}: {c_['bytes']} bytes, {c_['ops']} bf16 ops)")
    times = {r: {} for r in roots}
    for rnd in range(rounds):
        for root in roots + roots[::-1]:
            res = json.loads(subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--measure",
                 root], check=True, capture_output=True,
                text=True).stdout.splitlines()[-1])
            for case, (ms, dev_ms, by_kernel) in res.items():
                times[root].setdefault(case, []).append(ms)
                kern = "; ".join(f"{k} {v:.4f}"
                                 for k, v in sorted(by_kernel.items()))
                dev = ("not measured" if dev_ms is None
                       else f"{dev_ms:.4f} ms ({kern})")
                print(f"core_long_bench: round {rnd} {root} {case}: "
                      f"{ms:.4f} ms, device {dev} [{power}]")
    for root in roots:
        for case, ts in times[root].items():
            print(f"core_long_bench: {root} {case}: median "
                  f"{statistics.median(ts):.4f} ms of "
                  f"{' '.join(f'{t:.4f}' for t in ts)} [{power}]")


if __name__ == "__main__":
    main()
