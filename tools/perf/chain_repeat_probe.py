#!/usr/bin/env python3
"""Repeats the float formats' attention chain (K1 with ``qspec``) at
chip_smoke.py's kernel-phase shape (B=64, N=197, its seeded inputs) on
the card: each stage (``layernorm_snap_rows``, the qkv and projection
``gemm_f32x3_epilogue`` calls, ``attention_core_snap``) on its plain
version's input, and the whole op, the two products also on a fresh copy of their input
each call, every output
bitwise against the stage's first one, each call after the allocator's
next blocks were filled with NaN (an element that a kernel never writes
then shows); the op's first output against the plain chain.  Looks for
nondeterminism behind a one-off outlier of that chain (ROADMAP C11).

    python3 tools/perf/chain_repeat_probe.py [reps]     # default 40

Needs a CUDA device (and builds the kernels, as chip_smoke.py does).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def first_of(out):
    return out[0] if isinstance(out, tuple) else out


def main(reps):
    import torch

    import chip_smoke as cs
    from myrtle_vision_tpu_torch.ops import _kernels as K
    from myrtle_vision_tpu_torch.ops import fused_attention_block as fa
    from myrtle_vision_tpu_torch.ops.fake_quant import kernel_sites

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cs.phase_build()

    def poison():
        junk = torch.full((1 << 28,), float("nan"), device=device)
        del junk

    for qname, qspec in cs.FLOAT_QSPECS.items():
        x, attn, _ = cs.float_block_inputs(64, 197, seed=64 * 1000 + 197 + 2,
                                           device=device, qspec=qspec)
        s_ln, b_ln, wqkv, bqkv, wp, bp = attn
        b, n, c = x.shape
        x2 = x.contiguous().view(b * n, c)
        xn = K.layernorm_snap_rows_plain(x2, s_ln, b_ln,
                                         kernel_sites(qspec, 0))
        qkv = K.gemm_f32x3_epilogue_plain(
            xn, wqkv, bqkv, "bias_snap", kernel_sites(qspec, 1)).view(
                b, n, 3 * c)
        ctx = K.attention_core_snap_plain(qkv, cs.HEADS, cs.SCALE,
                                          kernel_sites(qspec, 2))
        stages = {
            "ln": lambda: K.layernorm_snap_rows_cuda(
                x2, s_ln, b_ln, kernel_sites(qspec, 0)),
            "qkv": lambda: K.gemm_f32x3_epilogue_cuda(
                xn, wqkv, bqkv, "bias_snap", kernel_sites(qspec, 1)),
            "core": lambda: K.attention_core_snap_cuda(
                qkv, cs.HEADS, cs.SCALE, kernel_sites(qspec, 2)),
            "proj": lambda: K.gemm_f32x3_epilogue_cuda(
                ctx.view(b * n, c), wp, bp, "bias_snap_residual_snap",
                kernel_sites(qspec, 3, 4), residual=x2),
            "proj, a fresh copy of its input": lambda: K.
            gemm_f32x3_epilogue_cuda(
                ctx.view(b * n, c).clone(), wp, bp,
                "bias_snap_residual_snap", kernel_sites(qspec, 3, 4),
                residual=x2),
            "qkv, a fresh copy of its input": lambda: K.
            gemm_f32x3_epilogue_cuda(xn.clone(), wqkv, bqkv, "bias_snap",
                                     kernel_sites(qspec, 1)),
            "op": lambda: fa.fused_attention_block(x, *attn, cs.HEADS,
                                                   cs.SCALE, qspec=qspec),
            "chain": lambda: chain(False),
            "chain, synchronized": lambda: chain(True),
            "chain, intermediates freed": lambda: chain(False, True)}

        def chain(sync, freed=False):
            """The op's kernels in its order, each fed the one before;
            every intermediate returned (and with ``sync`` a synchronize
            after each kernel; with ``freed`` copies of them, the
            intermediates themselves freed on return, as the op frees
            its own)."""
            outs = [K.layernorm_snap_rows_cuda(x2, s_ln, b_ln,
                                               kernel_sites(qspec, 0))]
            steps = (
                lambda t: K.gemm_f32x3_epilogue_cuda(
                    t, wqkv, bqkv, "bias_snap", kernel_sites(qspec, 1)),
                lambda t: K.attention_core_snap_cuda(
                    t.view(b, n, 3 * c), cs.HEADS, cs.SCALE,
                    kernel_sites(qspec, 2)),
                lambda t: K.gemm_f32x3_epilogue_cuda(
                    t.view(b * n, c), wp, bp, "bias_snap_residual_snap",
                    kernel_sites(qspec, 3, 4), residual=x2))
            for step in steps:
                if sync:
                    torch.cuda.synchronize()
                outs.append(step(outs[-1]))
            if freed:
                return [t.clone() for t in outs]
            return outs
        ref = fa.fused_attention_block_plain(x, *attn, cs.HEADS, cs.SCALE,
                                             qspec=qspec)
        for name, fn in stages.items():
            poison()
            firsts = fn()
            first = firsts[-1] if isinstance(firsts, list) else first_of(
                firsts)
            nan = int(torch.isnan(first).sum())
            bad, worst, where = 0, 0.0, []
            for _ in range(reps):
                poison()
                gots = fn()
                got = gots[-1] if isinstance(gots, list) else first_of(gots)
                torch.cuda.synchronize()
                if not torch.equal(got, first):
                    bad += 1
                    worst = max(worst, float((got - first).abs().max()))
                    if isinstance(gots, list):
                        # the first intermediate that differs
                        where.append(next(i for i, (g, f) in enumerate(
                            zip(gots, firsts)) if not torch.equal(g, f)))
            extra = (f"; against the plain chain max "
                     f"{float((first - ref).abs().max())}"
                     if name == "op" else "")
            if where:
                extra += (f"; first differing intermediate (0 LN, 1 qkv, 2 "
                          f"core, 3 projection) {where}")
            print(f"{qname} {name}: {nan} NaN, {bad} of {reps} repeats differ "
                  f"bitwise from the first, worst {worst}{extra}", flush=True)
    print(cs.power_line())


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 40)
